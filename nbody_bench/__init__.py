"""The benchmark of lambda_cdm_tpu_torch: BENCHMARK.json's cells run by
run.py (see harness.py)."""
