"""Particle updates a second: N times every step of every segment, over
the window's whole wall time (the resets and their bucketing included;
the window ends in a synchronise)."""


def read(ctx):
    if not ctx["wall_s"]:
        return None
    return ctx["n"] * ctx["steps"] / ctx["wall_s"]
