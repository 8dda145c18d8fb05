"""Force solvers. Only the PM mesh heuristic is ported so far; the
stateless solver registry (direct, pm, treepm) is ROADMAP work."""

from __future__ import annotations


def auto_pm_grid(config) -> int:
    """PM mesh size: configured value or ~2 cells per particle dimension
    (power-of-two >= cbrt(8N))."""
    if config.forces.pm_grid_size > 0:
        return int(config.forces.pm_grid_size)
    n = config.particles.num_particles
    ng = 16
    while ng ** 3 < 8 * n and ng < 1024:
        ng *= 2
    return ng
