"""Device time of the stateless PM's Poisson solve a step: the r2c, the
three gradient passes (pm_green_gradient_kernel, csrc/pm_cic.cu) and the
three c2r (the cuFFT kernels), inside the span pm.solve (ops/pm_cic.py),
read from the device trace by kernel name. Silent where the gradient
kernel never ran: the cuFFT kernels alone belong to no stateless PM."""

GRADIENT = r"pm_green_gradient_kernel"
PATTERN = GRADIENT + r"|(?i:fft)"


def read(ctx):
    tr = ctx["trace"]
    if not tr.kernels(GRADIENT) or not ctx["steps"]:
        return None
    return tr.seconds(tr.kernels(PATTERN)) * 1e3 / ctx["steps"]
