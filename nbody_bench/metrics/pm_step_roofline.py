"""The stateless PM step's share of its byte roofline, in %: the least
bytes any implementation of the spectral-gradient PM step must move in
the traced window, over 3.35 TB/s, divided by the window's device busy
time (core/engine.py _kdk_steps -> forces/pm.py pm_accelerations, and
the resets).

The window's force evaluations are its steps plus one a segment: the
reset drops the force, and the segment's first step evaluates it
again. The count reads the same whatever implements the step."""

from .. import peaks


def bytes_needed(n: int, ng: int) -> tuple:
    """(bytes a force evaluation, bytes a step) that the inputs need at
    n particles on the ng^3 mesh. Particle reads by the deposit and the
    gather are left out: a fused implementation takes them from the
    drift."""
    grid = 4.0 * ng ** 3                    # a float32 real grid
    half = 8.0 * ng * ng * (ng // 2 + 1)    # a complex64 half spectrum
    force = (grid                           # the density written
             + grid + half                  # the r2c: read, written
             + 3 * (half + grid)            # three c2r of -i k G rho_k
             + 3 * grid)                    # the gather reads the fields
    step = 48.0 * n                         # positions and velocities,
    return force, step                      # read and written


def read(ctx):
    tr = ctx["trace"]
    steps = ctx["steps"]
    if not tr.device or tr.busy_s <= 0 or not steps:
        return None
    force, step = bytes_needed(ctx["n"], ctx["geometry"]["ng"])
    evaluations = steps + steps // ctx["segment_steps"]
    bound = (evaluations * force + steps * step) / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / tr.busy_s
