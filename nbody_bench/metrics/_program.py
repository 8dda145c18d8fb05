"""What the program's own spans and counters recorded in the traced
window: lambda_cdm_tpu_torch.utils.profiling.trace_totals(), which
records only while a torch profiler is active, and only the traced
window runs under one.

A span's device seconds are the stream time between the CUDA events
around it, so they include any time the device sat idle inside the
span; a span that records no events reports its host seconds."""


def totals():
    """The program's trace totals, or None where it has none: a program
    without spans, or a window in which its run loop recorded no
    `engine.chunk`."""
    try:
        from lambda_cdm_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "trace_totals", None)
    if read is None:
        return None
    tot = read()
    return tot if "engine.chunk" in tot["spans"] else None


def device_seconds(tot, *names) -> float:
    """The summed device seconds of the spans `names` (0 where one never
    opened in the window)."""
    return sum(tot["spans"][n]["device_s"] for n in names
               if n in tot["spans"])


def per_step(ctx, value):
    return value / ctx["steps"] if ctx["steps"] else None
