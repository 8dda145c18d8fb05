"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

Not a test module. Every input is made with numpy from a seed and handed
to both packages as numpy arrays: the JAX package (lambda_cdm_tpu) runs
on the CPU as its own tests run it, the port (lambda_cdm_tpu_torch) on
CPU tensors, where each kernel wrapper takes its plain PyTorch version.
"""

import dataclasses

import numpy as np
import pytest
import torch

# tier-1 runs several xdist workers: one intra-op thread each
torch.set_num_threads(1)


def fields(obj) -> dict:
    """A JAX dataclass's fields as numpy arrays (the interop hand-off)."""
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def tt(x, dtype=torch.float32) -> torch.Tensor:
    """numpy (or a JAX array) -> CPU tensor (a copy: JAX buffers are
    read-only)."""
    return torch.tensor(np.asarray(x), dtype=dtype)


def nn(x) -> np.ndarray:
    """A tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def max_rel(got, ref, mask=None) -> float:
    """max |got - ref| / max |ref| (over `mask` when given)."""
    got, ref = np.asarray(nn(got), np.float64), np.asarray(nn(ref),
                                                           np.float64)
    diff = np.abs(got - ref)
    if mask is not None:
        diff = np.where(mask, diff, 0.0)
        ref = np.where(mask, ref, 0.0)
    return float(diff.max() / max(np.abs(ref).max(), 1e-300))


def assert_binned_match(counts_t, counts_j, power_t, power_j, k_t=None,
                        k_j=None, tol=1e-4, run_tol=1e-3):
    """The assignment-invariant comparison of two binned spectra (the port
    first): bins with equal mode counts agree in power within `tol`
    (relative to the larger of |P| and 1% of the largest bin's); over each
    run of adjacent bins whose counts differ, the count is conserved and
    the count-weighted power agrees within `run_tol`."""
    ct, cj = np.asarray(nn(counts_t), np.float64), np.asarray(counts_j,
                                                              np.float64)
    pt, pj = np.asarray(nn(power_t), np.float64), np.asarray(power_j,
                                                             np.float64)
    same = ct == cj
    scale = np.abs(pj).max()
    good = same & (cj > 0)
    assert good.sum() >= 0.8 * (cj > 0).sum()
    assert np.all(np.abs(pt - pj)[good] <= tol * np.maximum(np.abs(pj[good]),
                                                            1e-2 * scale))
    if k_t is not None:
        assert max_rel(np.asarray(nn(k_t))[good], np.asarray(k_j)[good]) \
            <= tol
    idx = np.nonzero(~same)[0]
    if idx.size:
        for run in np.split(idx, np.nonzero(np.diff(idx) > 1)[0] + 1):
            assert ct[run].sum() == cj[run].sum()
            w = np.sum(cj[run] * np.abs(pj[run])) + 1e-30
            assert abs(np.sum(ct[run] * pt[run])
                       - np.sum(cj[run] * pj[run])) / w <= run_tol


def uniform_particles(n, box, seed, mass_range=(0.5, 2.0)):
    """(positions [n, 3] in [0, box), masses [n]) as float32 numpy."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (n, 3)).astype(np.float32)
    m = rng.uniform(*mass_range, n).astype(np.float32)
    return pos, m


def half_box_lattice(box, seed, side=8):
    """A lattice of side^3 unit masses, jittered in y and z, whose middle
    x layer sits one ulp past half a box from layer 0: for those pairs
    d * (1/box) and d / box round to different minimum images. Returns
    (positions, masses, flips), flips counting such pairs along x."""
    g = np.arange(side, dtype=np.float32) * np.float32(box / side)
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    pos[:, 1:] = np.mod(pos[:, 1:] + rng.uniform(-0.3, 0.3, (len(pos), 2)),
                        box)
    half = np.float32(box / 2)
    pos[pos[:, 0] == half, 0] = np.nextafter(half, np.float32(box))
    pos = pos.astype(np.float32)
    d = pos[None, :, 0] - pos[:, None, 0]
    box32 = np.float32(box)
    flips = int(np.sum(np.round(d * (np.float32(1) / box32))
                       != np.round(d / box32)))
    return pos, np.ones(len(pos), np.float32), flips


def clustered_particles(n, box, seed, n_clump, sigma, centre):
    """Uniform background plus a Gaussian clump of n_clump particles."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, box, (n, 3))
    pos[:n_clump] = np.asarray(centre) + sigma * rng.standard_normal(
        (n_clump, 3))
    pos = np.mod(pos, box).astype(np.float32)
    m = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return pos, m


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test without one (decided at run
    time, never at import, so every xdist worker collects the same
    tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU host: python -m pytest "
                    "tests/test_torch_cuda.py -m cuda --noconftest)")
    return torch.device("cuda", 0)


# K8's schedule as csrc/short_range_rd.cu compiles it, for the tests that
# emulate it or must reach its streaming: partial sums a lane (kIlp) and
# the 128-slot tiles one stage buffer holds (kStageTiles)
K8_ILP = 4
K8_STAGE_TILES = 32


def k8_union_tiles(tables, counts, k_rod, group):
    """[R, K_rod / (16 group)] tiles in the union K8 stages for each work
    item (group consecutive 16-row chunks of a rod): for each of the 27
    entries, the span of the live chunks' tile ranges, summed."""
    ent = tables.cpu().to(torch.int64)
    nrods, nch = ent.shape[0], ent.shape[1]
    ent = ent.reshape(nrods, nch // group, group, 27)
    st, nt = ent >> 10, (ent >> 2) & 255
    chunk = torch.arange(nch).reshape(1, nch // group, group, 1)
    live = chunk * 16 < counts.cpu().to(torch.int64).reshape(-1, 1, 1, 1)
    has = live & (nt > 0)
    lo = torch.where(has, st, 1 << 30).amin(dim=2)
    hi = torch.where(has, st + nt, 0).amax(dim=2)
    return torch.clamp(hi - lo, min=0).sum(dim=-1)
