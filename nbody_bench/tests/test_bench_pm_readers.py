"""The stateless PM cell's readers (pm_cic_ms_per_step,
pm_solve_ms_per_step, pm_scatter_roofline, pm_gather3_roofline) on a
synthetic trace, silent on a trace without their kernels, and their
byte counts by hand at pm_256's size."""

import os

import pytest

from nbody_bench import harness, peaks, trace
from nbody_bench.metrics import pm_gather3_roofline, pm_scatter_roofline

NAMES = ["pm_cic_ms_per_step", "pm_solve_ms_per_step",
         "pm_scatter_roofline", "pm_gather3_roofline"]
SMALL = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "trace_small.json")


def _kernel(name, ts, dur):
    return (f"void (anonymous namespace)::{name}(float const*)", "kernel",
            ts, dur)


@pytest.fixture
def pm_trace():
    """Two steps' worth of one stateless PM force each: scatter 30 us,
    gradient 3 x 5 us, cuFFT 4 x 10 us, gather 50 us; a memset and an
    elementwise kernel that no reader claims."""
    dev = [_kernel("pm_cic_scatter_kernel", 0, 30),
           _kernel("pm_green_gradient_kernel", 40, 5),
           ("regular_fft_factor_256", "kernel", 50, 10),
           _kernel("pm_cic_gather3_kernel", 100, 50),
           ("Memset (Device)", "gpu_memset", 160, 4),
           ("at::native::vectorized_elementwise_kernel", "kernel", 170, 6)]
    dev = dev + [(n, c, ts + 200.0, d) for n, c, ts, d in dev]
    dev += [_kernel("pm_green_gradient_kernel", 300, 5)] * 4
    dev += [("vector_fft_c2r", "kernel", 320, 10)] * 6
    return trace.Trace(window_s=400e-6, busy_s=300e-6, device=dev)


def _ctx(tr, n=1000, ng=16):
    return {"trace": tr, "steps": 2, "n": n, "segment_steps": 2,
            "geometry": {"ng": ng, "box": 10.0}}


def test_readers_on_a_synthetic_trace(pm_trace):
    got = harness.read_metrics([{"name": n, "unit": "u"} for n in NAMES],
                               _ctx(pm_trace))
    assert got["pm_cic_ms_per_step"]["value"] == pytest.approx(
        2 * (30 + 50) * 1e-3 / 2)
    # 6 gradient passes (5 us) and 8 cuFFT kernels (10 us) in 2 steps
    assert got["pm_solve_ms_per_step"]["value"] == pytest.approx(
        (6 * 5 + 8 * 10) * 1e-3 / 2)
    scatter = (16 * 1000 + 4 * 16 ** 3) / peaks.HBM_BYTES_PER_S
    gather = (12 * 16 ** 3 + 24 * 1000) / peaks.HBM_BYTES_PER_S
    assert got["pm_scatter_roofline"]["value"] == pytest.approx(
        100 * scatter / 30e-6)
    assert got["pm_gather3_roofline"]["value"] == pytest.approx(
        100 * gather / 50e-6)


@pytest.mark.parametrize("tr", ["empty", "fast_path"])
def test_readers_stay_silent_without_their_kernels(tr):
    """No trace of the kernels (the fast path's K1/K2/K3 and cuFFT, or
    nothing): every reader returns None, as on a program that lacks
    them."""
    tr = trace.Trace(window_s=1.0, busy_s=0.0) if tr == "empty" \
        else trace.summary(SMALL)
    assert harness.read_metrics([{"name": n, "unit": "u"} for n in NAMES],
                                _ctx(tr)) == {}


def test_byte_counts_by_hand_at_pm_256():
    n, ng = 2_097_152, 256
    # the scatter: 16 B of position and mass a particle (33,554,432 B),
    # the 256^3 float32 grid written once (67,108,864 B)
    assert pm_scatter_roofline.bytes_needed(n, ng) == 100_663_296
    # the gather: three 256^3 float32 fields read (201,326,592 B), 12 B
    # of position read and 12 B of acceleration written a particle
    # (50,331,648 B)
    assert pm_gather3_roofline.bytes_needed(n, ng) == 251_658_240
