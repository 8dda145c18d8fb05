"""One reader a metric: metrics/<name>.py defines read(ctx) -> float or
None, found by the metric's name in BENCHMARK.json. A reader that finds
nothing to read returns None and the harness leaves the metric out."""
