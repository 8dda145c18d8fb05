"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit), the ones chip_smoke.py's bound() uses."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # float32 outside the tensor cores
