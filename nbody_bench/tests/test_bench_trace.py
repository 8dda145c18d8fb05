"""The per-layer readers and the roofline counts on a small recorded
trace (tests/trace_small.json: two steps of one of each kernel kind)."""

import itertools
import os

import numpy as np
import pytest
import torch

from nbody_bench import harness, peaks, reference, trace
from nbody_bench.metrics import (k3_roofline, pm_kernels_roofline,
                                 pm_step_roofline)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "trace_small.json")


@pytest.fixture
def small():
    return trace.summary(FIXTURE)


def _ctx(tr, **kw):
    ctx = {"trace": tr, "steps": 2, "n": 1000,
           "geometry": {"ng": 16, "box": 10.0, "r_cut": 1.5},
           "rng": np.random.default_rng(0)}
    ctx.update(kw)
    return ctx


def test_summary(small):
    assert small.window_s == pytest.approx(120e-6)
    assert small.busy_s == pytest.approx(86e-6)
    assert len(small.kernels("short_range_kernel")) == 1


def test_layer_readers(small):
    names = ["launches_per_step", "pm_ms_per_step", "k3_ms_per_step",
             "glue_ms_per_step", "device_idle_share"]
    got = harness.read_metrics([{"name": n, "unit": "u"} for n in names],
                               _ctx(small))
    want = {"launches_per_step": 3.0, "pm_ms_per_step": 0.014,
            "k3_ms_per_step": 0.026, "glue_ms_per_step": 0.003,
            "device_idle_share": 100.0 * (1 - 86 / 120)}
    for n, v in want.items():
        assert got[n]["value"] == pytest.approx(v)


def test_readers_stay_silent_without_their_kernels(small):
    empty = trace.Trace(window_s=1.0, busy_s=0.0)
    names = ["launches_per_step", "pm_ms_per_step", "k3_ms_per_step",
             "glue_ms_per_step", "device_idle_share", "k3_roofline",
             "pm_kernels_roofline", "pm_step_roofline"]
    assert harness.read_metrics([{"name": n, "unit": "u"} for n in names],
                                _ctx(empty, segment_steps=2)) == {}


def test_pm_kernels_roofline(small):
    got = pm_kernels_roofline.read(_ctx(small))
    bound = (16 * 1000 + 4 * 16 ** 3 + 4 * 16 ** 3 + 24 * 1000) \
        / peaks.HBM_BYTES_PER_S
    assert got == pytest.approx(100 * bound / 20e-6)


def test_pm_step_bytes_by_hand():
    # ng 4: a real grid 64 float32 (256 B), a half spectrum 4 x 4 x 3
    # complex64 (384 B); a force writes the density (256), reads and
    # writes the r2c (256 + 384), three c2r (3 x (384 + 256)), and the
    # gather reads three fields (3 x 256); a step moves 48 B a particle
    force, step = pm_step_roofline.bytes_needed(10, 4)
    assert force == 256 + (256 + 384) + 3 * (384 + 256) + 3 * 256 == 3584
    assert step == 480


def test_pm_step_roofline(small):
    # 2 steps in one segment of 2: 3 force evaluations
    got = pm_step_roofline.read(_ctx(small, segment_steps=2))
    force, step = pm_step_roofline.bytes_needed(1000, 16)
    want = 100 * (3 * force + 2 * step) / peaks.HBM_BYTES_PER_S / 86e-6
    assert got == pytest.approx(want)


def test_needed_pairs_is_the_plain_count():
    gen = torch.Generator().manual_seed(4)
    pos = torch.rand((600, 3), generator=gen) * 10.0
    targets = torch.arange(600)
    got = k3_roofline.needed_pairs(pos, 10.0, 1.5, targets)
    d = pos[:, None, :] - pos[None, :, :]
    d = d - 10.0 * torch.round(d / 10.0)
    r2 = (d.double() ** 2).sum(-1)
    want = int(((r2 < 1.5 ** 2) & ~torch.eye(600, dtype=torch.bool)).sum())
    assert got == want


def test_k3_roofline(small):
    gen = torch.Generator().manual_seed(5)
    pos = torch.rand((1000, 3), generator=gen) * 10.0
    ctx = _ctx(small, start_positions=pos)
    got = k3_roofline.read(ctx)
    pairs = k3_roofline.needed_pairs(
        pos, 10.0, 1.5, torch.as_tensor(np.random.default_rng(0).choice(
            1000, 1000, replace=False)))
    want = 100 * pairs * k3_roofline.FLOPS_PER_PAIR / peaks.FP32_FLOPS \
        / 52e-6
    assert got == pytest.approx(want)


def test_breakdown_names_gaps_by_the_host(small):
    b = trace.breakdown(small)
    assert b["device_ops"][0] == ["void (anonymous namespace)::"
                                  "short_range_kernel<0>(float const*)",
                                  pytest.approx(50e-6)]
    idle = dict(b["idle_gaps"])
    assert idle["bench.segment"] == pytest.approx(7e-6)
    assert idle["aten::mul"] == pytest.approx(4e-6)


def test_pair_chunks_cover_every_stencil_pair():
    gen = torch.Generator().manual_seed(6)
    pos = torch.rand((300, 3), generator=gen, dtype=torch.float64) * 9.0
    cid = reference.cell_ids(pos, 9.0, 3)
    targets = torch.tensor([0, 5, 17])
    old = reference.PAIR_CHUNK
    try:
        reference.PAIR_CHUNK = 250       # several chunks
        seen = [(int(targets[t0:t1][ti[k]]), int(j[k]))
                for t0, t1, ti, j, d in reference.pair_chunks(
                    pos, cid, targets, ncell=3, box=9.0)
                for k in range(j.numel())]
    finally:
        reference.PAIR_CHUNK = old
    # ncell 3: the 27 neighbour cells are every cell, each once
    assert sorted(seen) == sorted(itertools.product(targets.tolist(),
                                                    range(300)))
