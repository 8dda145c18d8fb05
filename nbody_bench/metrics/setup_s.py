"""From process start to the first timed step: imports, the kernel
library (built on the first run of a checkout), the inputs, the engine's
build and the warm-up segment."""


def read(ctx):
    return ctx["setup_s"]
