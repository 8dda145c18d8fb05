"""K4 and K4s: the softened minimum-image O(N^2) direct sum, and K9: the
pair sum of the potential energy -- the CUDA kernels csrc/direct.cu with
their plain PyTorch versions (K4/K4s are the counterpart of
lambda_cdm_tpu/ops/pallas_direct.py; K9 replaces the XLA row-block scan of
lambda_cdm_tpu/forces/direct.potential_energy).

For every particle i:
    a_i = G sum_j m_j (r^2)^(-3/2) d,  d = x_j - x_i (minimum image),
    r^2 = |d|^2 + eps^2.
The variants compute that one function with the TPU kernels' arithmetic:

  v1    physical units, d -= box * round(d / box),
        r^2 = ((dx^2 + dy^2) + dz^2) + eps^2, w = m_j r^-3;
  v2    coordinates in box units, d -= round(d),
        r^2 = dx^2 + (dy^2 + (dz^2 + eps^2)), output times G / box^2;
  sym   each unordered pair once: forces m_i m_j r^-3 d, physical units,
        divided by m_i at the end (zero mass gives 0);
  sym2  sym in box units.

round() rounds half to even, as jnp.round does. The physical-unit image
takes the true quotient d / box, as forces/direct.min_image (the CPU
solver) does; the TPU kernels multiply by 1/box, which picks the other
image for some pairs next to half a box apart. CUDA tensors launch K4
(v1, v2) or K4s (sym, sym2); CPU tensors take the plain version. There
is no fallback: a CUDA tensor goes to its kernel or the call raises.

Cross forms (the multi-rank ring, parallel/sharded.py): K4 on n targets
against m separate sources (pairwise_accelerations_cross, v1 and v2) and
K9 over every ordered (target, source) pair of two sets
(pair_potential_cross), each with a plain version beside it. The solver's
calls pass one array as both sets, so their bytes are those of the
symmetric entries.

K4 rounds the image with a magic constant, exact while every position
lies within 2^21 boxes of the origin. It checks that on the card without
a readback: a position past it sets a flag on the device, and
check_range() (called by the engine at each chunk end, where it
synchronises anyway) raises if it is set. K4s needs no flag: it takes the
image from thresholds on |d| (image_thresholds) where a tile's positions
span at most 1.5 boxes, and the quotient with rintf elsewhere, both exact.
"""

from __future__ import annotations

import functools

import torch

from ..forces.direct import min_image
from . import cuda_build

THREADS = 128     # threads a block of K4 (kThreads in direct.cu)
TILE_ROWS = 128   # i rows a block of K4 (kTileRows in direct.cu)
J_TILE = 128      # j tile of K4; its slices are whole tiles (kJTile)
# K4's grid: about this many (i tile, j slice) blocks, eleven an H100 SM
# (17 slices at 10,648 particles; 1 from 782 i tiles, about 100k, up)
TARGET_BLOCKS = 11 * 132
SYM_TILE = 256    # tile edge of K4s (kSymTile in direct.cu)
# K4s's grid: about this many (i tile, run of k) blocks, 2 resident an H100
# SM and ~38 rounds of them (391 tiles x 26 runs at 100k particles)
SYM_BLOCKS = 10_000
PAIR_TILE = 512   # tile edge of K9 (kPairTile in direct.cu)
# K4 and K9 round d / box with the magic constant 1.5 * 2^23, exact while
# |d / box| < 2^22: positions must lie within 2^21 boxes of the origin
PAIR_POSITION_LIMIT = 2.0 ** 21
VARIANTS = ("v1", "v2", "sym", "sym2")

launches = {"direct": 0, "direct_sym": 0, "pair_potential": 0,
            "direct_cross": 0, "pair_potential_cross": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def j_slices(n: int, m: int | None = None) -> int:
    """K4's j slices S for n targets and m sources (m = n by default):
    TARGET_BLOCKS // (i tiles), at least 1 and at most one a j tile (1
    from about 100k targets up)."""
    m = n if m is None else m
    tiles = max(1, -(-n // TILE_ROWS))
    return max(1, min(TARGET_BLOCKS // tiles, -(-m // J_TILE)))


def slice_bounds(n: int, m: int | None = None):
    """[(j0, j1)] of K4's j slices over m sources (m = n by default), as
    the kernel computes them: slice s takes the j tiles floor(s T / S) ..
    floor((s + 1) T / S) - 1 of the T = ceil(m / J_TILE)."""
    m = n if m is None else m
    ntj, s = -(-m // J_TILE), j_slices(n, m)
    return [(k * ntj // s * J_TILE, min(m, (k + 1) * ntj // s * J_TILE))
            for k in range(s)]


# per device: the int32 flag K4 sets when a position lies 2^21 boxes or
# more from the origin
_range_flags: dict = {}


def _range_flag(device):
    flag = _range_flags.get(device)
    if flag is None:
        flag = _range_flags[device] = torch.zeros(1, dtype=torch.int32,
                                                  device=device)
    return flag


def check_range() -> None:
    """Raise if a K4 launch since the last check met a position 2^21
    boxes or more from the origin (its image may be off by a box there),
    and clear the flag: one readback for each device K4 has run on,
    none before its first launch."""
    for device, flag in _range_flags.items():
        if int(flag):
            flag.zero_()
            raise ValueError(
                f"direct kernel on {device}: a position lies "
                f"{PAIR_POSITION_LIMIT:g} boxes or more from the origin, "
                f"where its minimum image is not exact")


def _check(softening, variant):
    if float(softening) <= 0.0:
        raise ValueError("the direct kernel requires softening > 0")
    if variant not in VARIANTS:
        raise ValueError(f"unknown direct variant {variant!r}; choose from "
                         f"{VARIANTS}")


def _scale(box_size: float, variant: str) -> float:
    """Coordinate factor: 1/box for the box-unit variants, else 1."""
    return 1.0 / box_size if variant in ("v2", "sym2") else 1.0


def sym_tiles(n: int) -> int:
    """K4s tile count: ceil(n / SYM_TILE), made odd so that the half-matrix
    wrap covers every unordered tile pair once."""
    p = max(1, (n + SYM_TILE - 1) // SYM_TILE)
    return p if p % 2 else p + 1


def sym_runs(n: int) -> int:
    """K4s's runs of k a tile: about SYM_BLOCKS blocks in all, at least 1
    and at most one a k (half + 1 of them)."""
    ntiles = sym_tiles(n)
    return max(1, min((ntiles + 1) // 2, -(-SYM_BLOCKS // ntiles)))


def sym_schedule(n: int):
    """K4s's blocks as the kernel decodes blockIdx: [(p, k0, k1)], block b
    = p runs + r takes i tile p against the j tiles (p + k) mod P for k0 <=
    k < k1, with P = sym_tiles(n), runs = sym_runs(n) and run r's k0 =
    floor(r K / runs), K = (P - 1) // 2 + 1. The block with k = 0 (q = p)
    adds rows only; the others write a column partial for each k. Blocks
    of the odd count's pad tile (p * SYM_TILE >= n) return at once."""
    ntiles, runs = sym_tiles(n), sym_runs(n)
    kk = (ntiles - 1) // 2 + 1
    return [(p, r * kk // runs, (r + 1) * kk // runs)
            for p in range(ntiles) for r in range(runs)]


@functools.lru_cache(maxsize=64)
def image_thresholds(box: float):
    """(T, T2) for K4s's image, float32 numbers computed with float32
    division as the plain version divides: T the largest x >= 0 whose
    quotient fl(x / box) is at most 0.5 (so rint(d / box) is sign(d) for
    T < |d| and 0 below), T2 the largest x whose quotient stays below 1.5
    (the range where that holds). Cached: a call at 10k particles takes
    ~80 us on the card, less than these float loops on the host."""
    import numpy as np
    b = np.float32(box)
    up, down = np.float32(np.inf), np.float32(0)

    def last(limit, ok):
        x = np.float32(limit) * b
        while not ok(x):
            x = np.nextafter(x, down)
        while ok(np.nextafter(x, up)):
            x = np.nextafter(x, up)
        return float(x)

    return (last(0.5, lambda x: x / b <= np.float32(0.5)),
            last(1.5, lambda x: x / b < np.float32(1.5)))


def pair_tiles(n: int) -> int:
    """K9 tile count: ceil(n / PAIR_TILE), made odd."""
    p = max(1, (n + PAIR_TILE - 1) // PAIR_TILE)
    return p if p % 2 else p + 1


def pair_schedule(n: int):
    """K9's blocks as the kernel decodes blockIdx: ([B] row tile p, [B]
    column tile q) with B = P (half + 1), P = pair_tiles(n), half =
    (P - 1) // 2; block b takes p = b // (half + 1), k = b % (half + 1),
    q = (p + k) mod P. The block with q == p sums the pairs j > i of its
    tile, the others every pair of tile p against tile q."""
    ntiles = pair_tiles(n)
    half = (ntiles - 1) // 2
    b = torch.arange(ntiles * (half + 1))
    p = b // (half + 1)
    return p, (p + b % (half + 1)) % ntiles


def pairwise_accelerations_plain(positions, masses, box_size, softening=0.01,
                                 g_const=1.0, *, periodic: bool = True,
                                 variant: str = "v1", sources=None,
                                 source_masses=None):
    """Plain PyTorch K4/K4s: [N, 3] accelerations with each variant's
    arithmetic, in row blocks of about 8M pairs. With `sources` (and
    `source_masses`; v1 and v2 only) the rows `positions` are summed over
    those sources instead of over themselves (K4's cross form)."""
    _check(softening, variant)
    box_size = float(box_size)
    scale = _scale(box_size, variant)
    sym = variant in ("sym", "sym2")
    soft2 = (float(softening) * scale) ** 2
    tgt = positions.to(torch.float32) * scale
    if sources is None:
        pos, m = tgt, masses.to(torch.float32)
    else:
        if sym:
            raise ValueError("the cross form takes v1 or v2")
        pos = sources.to(torch.float32) * scale
        m = source_masses.to(torch.float32)
    n = tgt.shape[0]
    chunk = max(1, (1 << 23) // max(pos.shape[0], 1))
    out = torch.empty((n, 3), dtype=torch.float32, device=pos.device)
    for i0 in range(0, n, chunk):
        pi = tgt[i0:i0 + chunk]
        d = [pos[None, :, c] - pi[:, c, None] for c in range(3)]
        if periodic:
            # the box-unit variants wrap with box = 1, as the TPU kernels do
            if variant in ("v2", "sym2"):
                d = [dc - torch.round(dc) for dc in d]
            else:
                d = [min_image(dc, box_size) for dc in d]
        dx, dy, dz = d
        if variant == "v1":
            r2 = dx * dx + dy * dy + dz * dz + soft2
        else:
            r2 = dx * dx + (dy * dy + (dz * dz + soft2))
        inv_r = torch.rsqrt(r2)
        if sym:
            mi = m[i0:i0 + chunk, None]
            w = (m[None, :] * mi) * (inv_r * inv_r * inv_r)
        else:
            w = m[None, :] * (inv_r * inv_r * inv_r)
        f = torch.stack([torch.sum(w * dc, dim=1) for dc in d], dim=1)
        if sym:
            mi = m[i0:i0 + chunk]
            inv_m = torch.where(mi > 0, 1.0 / torch.where(mi > 0, mi, 1.0),
                                0.0)
            f = f * inv_m[:, None]
        out[i0:i0 + chunk] = f
    return (float(g_const) * scale * scale) * out


def pairwise_accelerations(positions, masses, box_size, softening=0.01,
                           g_const=1.0, *, periodic: bool = True,
                           variant: str = "v1"):
    """Softened pairwise accelerations [N, 3] (minimum image unless
    `periodic` is False). CUDA tensors launch K4 (v1, v2) or K4s (sym,
    sym2) from csrc/direct.cu, replacing pallas_direct's _direct_kernel,
    _direct_kernel_v2 and _direct_kernel_sym; CPU tensors take
    pairwise_accelerations_plain. Requires softening > 0. For K4 a
    position 2^21 boxes or more from the origin sets the flag
    check_range() reads; the call itself never synchronises."""
    _check(softening, variant)
    if positions.device.type == "cpu":
        return pairwise_accelerations_plain(
            positions, masses, box_size, softening, g_const,
            periodic=periodic, variant=variant)
    box_size = float(box_size)
    n = positions.shape[0]
    scale = _scale(box_size, variant)
    pts = _points(positions, masses, scale)
    cuda_build.require_cuda("direct", pts)
    if variant in ("v1", "v2"):
        launches["direct"] += 1
        return _launch_k4(pts, pts, box_size, softening, g_const, periodic,
                          variant)
    out = torch.empty((n, 3), dtype=torch.float32, device=pts.device)
    soft2 = (float(softening) * scale) ** 2
    oscale = float(g_const) * scale * scale
    box = box_size * scale
    ntiles, runs = sym_tiles(n), sym_runs(n)
    half = (ntiles - 1) // 2
    rowpart = torch.empty((ntiles * runs, 3, SYM_TILE),
                          dtype=torch.float32, device=pts.device)
    colpart = torch.empty((max(ntiles * half, 1), 3, SYM_TILE),
                          dtype=torch.float32, device=pts.device)
    if variant == "sym2":
        box = 1.0
    half_t, span_t = image_thresholds(box)
    launches["direct_sym"] += 1
    cuda_build.launch("lcdm_direct_sym", pts.data_ptr(), rowpart.data_ptr(),
                      colpart.data_ptr(), out.data_ptr(), n, ntiles, runs,
                      int(bool(periodic)), box, soft2, oscale, half_t,
                      span_t)
    return out


def _points(positions, masses, scale: float = 1.0):
    """The kernels' [N, 4] float32 rows (x, y, z) * scale, m."""
    n = positions.shape[0]
    if tuple(positions.shape) != (n, 3) or tuple(masses.shape) != (n,):
        raise ValueError(f"positions must be [N, 3] and masses [N], got "
                         f"{tuple(positions.shape)} and "
                         f"{tuple(masses.shape)}")
    return torch.cat([positions.to(torch.float32) * scale,
                      masses.to(torch.float32)[:, None]], dim=1).contiguous()


def _launch_k4(pts, src, box_size: float, softening, g_const, periodic,
               variant: str):
    """One K4 launch: the rows pts [n, 4] against the sources src [m, 4]
    (the same tensor for the solver)."""
    n, m = pts.shape[0], src.shape[0]
    scale = _scale(box_size, variant)
    out = torch.empty((n, 3), dtype=torch.float32, device=pts.device)
    flag = _range_flag(pts.device)
    slices = j_slices(n, m)
    partial = torch.empty((slices, n, 3) if slices > 1 else (0,),
                          dtype=torch.float32, device=pts.device)
    cuda_build.launch("lcdm_direct", pts.data_ptr(), src.data_ptr(),
                      out.data_ptr(), partial.data_ptr(), flag.data_ptr(), n,
                      m, slices, int(variant == "v2"), int(bool(periodic)),
                      box_size, (float(softening) * scale) ** 2,
                      float(g_const) * scale * scale,
                      PAIR_POSITION_LIMIT * box_size * scale)
    return out


def pairwise_accelerations_cross(targets, sources, source_masses, box_size,
                                 softening=0.01, g_const=1.0, *,
                                 periodic: bool = True, variant: str = "v1"):
    """K4's cross form: accelerations [n, 3] on the rows `targets` [n, 3]
    from the m `sources` [m, 3] with `source_masses` [m] (v1 or v2
    arithmetic), the per-step sum of the multi-rank ring
    (parallel/sharded.ring_direct_accelerations). CUDA tensors launch K4
    with the sources as a separate array (launch key "direct_cross"); CPU
    tensors take pairwise_accelerations_plain(..., sources=...)."""
    _check(softening, variant)
    if variant not in ("v1", "v2"):
        raise ValueError("the cross form takes v1 or v2")
    if targets.device.type == "cpu":
        return pairwise_accelerations_plain(
            targets, targets.new_zeros(targets.shape[0]), box_size,
            softening, g_const, periodic=periodic, variant=variant,
            sources=sources, source_masses=source_masses)
    box_size = float(box_size)
    scale = _scale(box_size, variant)
    tgt = _points(targets, targets.new_zeros(targets.shape[0]), scale)
    src = _points(sources, source_masses, scale)
    cuda_build.require_cuda("direct_cross", tgt, src)
    launches["direct_cross"] += 1
    return _launch_k4(tgt, src, box_size, softening, g_const, periodic,
                      variant)


def _soft2_thr(softening):
    """(eps^2, eps^2 + 1e-30) as float32 numbers, rounded as the plain
    version rounds them."""
    soft2 = torch.tensor(softening, dtype=torch.float32) ** 2
    return float(soft2), float(soft2 + 1e-30)


def pair_potential_plain(positions, masses, box_size, softening=0.01,
                         g_const=1.0, chunk_size=2048):
    """Plain PyTorch K9: U = -G/2 sum_{i != j} m_i m_j / sqrt(r_ij^2 +
    eps^2), minimum image, as a 0-d float64 tensor; blocks of at most
    `chunk_size` rows (fewer where N is large, so a block stays about 8M
    pairs), block sums accumulated in float64. Pairs with r^2 <= eps^2 +
    1e-30 (the self pair) are left out, as in the JAX package."""
    n = positions.shape[0]
    rows = max(1, min(chunk_size, (1 << 23) // max(n, 1)))
    soft2 = torch.tensor(softening, dtype=positions.dtype,
                         device=positions.device) ** 2
    total = torch.zeros((), dtype=torch.float64, device=positions.device)
    for i0 in range(0, n, rows):
        d = min_image(positions[None, :, :]
                      - positions[i0:i0 + rows, None, :], box_size)
        r2 = torch.sum(d * d, dim=-1) + soft2
        inv_r = torch.where(r2 <= soft2 + 1e-30, 0.0, torch.rsqrt(r2))
        pair = (masses[i0:i0 + rows, None] * masses[None, :]) * inv_r
        total = total + torch.sum(pair, dtype=torch.float64)
    return -0.5 * float(g_const) * total


def pair_potential(positions, masses, box_size, softening=0.01, g_const=1.0,
                   chunk_size=2048):
    """The pairwise potential energy (see pair_potential_plain) as a 0-d
    float64 tensor. CUDA tensors launch K9 (csrc/direct.cu), which
    computes the function that lambda_cdm_tpu/forces/direct.potential_energy
    leaves to XLA, each unordered pair once (pair_schedule); CPU tensors
    take pair_potential_plain (`chunk_size` sets its row blocks).
    Deterministic: one float64 partial a block, no atomics."""
    if positions.device.type == "cpu":
        return pair_potential_plain(positions, masses, box_size, softening,
                                    g_const, chunk_size)
    n = positions.shape[0]
    pts = _points(positions, masses)
    cuda_build.require_cuda("pair_potential", pts)
    _check_pair_range(pts, box_size)
    ntiles = pair_tiles(n)
    partial = torch.empty((ntiles * ((ntiles - 1) // 2 + 1),),
                          dtype=torch.float64, device=pts.device)
    soft2, thr = _soft2_thr(softening)
    launches["pair_potential"] += 1
    cuda_build.launch("lcdm_pair_potential", pts.data_ptr(), None,
                      partial.data_ptr(), n, n, ntiles, float(box_size),
                      soft2, thr)
    return -float(g_const) * torch.sum(partial)


def _check_pair_range(pts, box_size) -> None:
    if pts.shape[0] and float(pts[:, :3].abs().max()) >= \
            PAIR_POSITION_LIMIT * float(box_size):
        raise ValueError(f"pair_potential: positions must lie within "
                         f"{PAIR_POSITION_LIMIT:g} boxes of the origin")


def pair_potential_cross_plain(positions, masses, source_positions,
                               source_masses, box_size, softening=0.01,
                               g_const=1.0):
    """Plain PyTorch K9 cross form: -G/2 sum over every ordered pair (i of
    `positions`, j of `source_positions`) of m_i m_j / sqrt(r^2 + eps^2),
    minimum image, pairs with r^2 <= eps^2 + 1e-30 left out (the JAX
    ring's guard), as a 0-d float64 tensor; row blocks of about 8M pairs,
    block sums in float64."""
    m = source_positions.shape[0]
    rows = max(1, (1 << 23) // max(m, 1))
    soft2 = torch.tensor(softening, dtype=positions.dtype,
                         device=positions.device) ** 2
    total = torch.zeros((), dtype=torch.float64, device=positions.device)
    for i0 in range(0, positions.shape[0], rows):
        d = min_image(source_positions[None, :, :]
                      - positions[i0:i0 + rows, None, :], box_size)
        r2 = torch.sum(d * d, dim=-1) + soft2
        inv_r = torch.where(r2 <= soft2 + 1e-30, 0.0, torch.rsqrt(r2))
        pair = (masses[i0:i0 + rows, None] * source_masses[None, :]) * inv_r
        total = total + torch.sum(pair, dtype=torch.float64)
    return -0.5 * float(g_const) * total


def pair_potential_cross(positions, masses, source_positions, source_masses,
                         box_size, softening=0.01, g_const=1.0):
    """K9's cross form (see pair_potential_cross_plain): the per-step sum
    of the ring energy (parallel/sharded.sharded_energy). With one set as
    both arguments it counts each unordered pair twice and so equals
    pair_potential. CUDA tensors launch K9's cross kernel (launch key
    "pair_potential_cross"; deterministic, one float64 partial a tile
    pair); CPU tensors take the plain version."""
    if positions.device.type == "cpu":
        return pair_potential_cross_plain(positions, masses,
                                          source_positions, source_masses,
                                          box_size, softening, g_const)
    pts = _points(positions, masses)
    src = _points(source_positions, source_masses)
    cuda_build.require_cuda("pair_potential_cross", pts, src)
    _check_pair_range(pts, box_size)
    _check_pair_range(src, box_size)
    n, m = pts.shape[0], src.shape[0]
    ntiles = -(-n // PAIR_TILE)
    partial = torch.empty((max(1, ntiles * -(-m // PAIR_TILE)),),
                          dtype=torch.float64, device=pts.device)
    if n == 0 or m == 0:
        partial.zero_()
    soft2, thr = _soft2_thr(softening)
    launches["pair_potential_cross"] += 1
    cuda_build.launch("lcdm_pair_potential", pts.data_ptr(), src.data_ptr(),
                      partial.data_ptr(), n, m, ntiles, float(box_size),
                      soft2, thr)
    return -0.5 * float(g_const) * torch.sum(partial)
