"""The port's CUDA kernels against their plain PyTorch versions on the card
(K1 CIC deposit, K2 fd4 gather, also on a 5,000-row cell and a mostly
dead layout, K3 short-range pairs in each split form,
K4/K4s direct sums, K5 FoF hook, K6/K7 lens samplers, K8 rod-dense
pairs, K9 pair potential, K10 alias probe), and the treepm_fast stepper,
fof_labels, the `direct` solver and the lensing trace on the card against
the same runs on the CPU. These need a CUDA
card and nvcc; elsewhere they skip:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py sets up JAX, which the GPU host lacks.)
"""

import math

import numpy as np
import pytest
import torch

from _torch_parity import clustered_particles, cuda_device, \
    half_box_lattice, tt, uniform_particles  # noqa: F401  (a fixture)

from lambda_cdm_tpu_torch.analysis import halo_finder
from lambda_cdm_tpu_torch.forces.direct import potential_energy
from lambda_cdm_tpu_torch.ops import alias_probe, direct, fast_treepm, \
    fof_hook, lens_sample, pm_rods, short_range, short_range_rd
from lambda_cdm_tpu_torch.ops.bucketed_pm import live_counts
from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams

pytestmark = pytest.mark.cuda


def _state(device, pos, m, box, ncell, cap, push=0.0):
    plan = {"ncell": ncell, "capacity": cap, "margin": 1, "rs": 1.0}
    fs = fast_treepm.build_fast_state(tt(pos).to(device), torch.zeros(
        pos.shape, device=device), tt(m).to(device), 0.5, box_size=box,
        plan=plan)
    assert int(fs.overflow) == 0
    bpos = fs.bpos.clone()
    if push:
        gen = torch.Generator(device=device).manual_seed(1)
        sel = (torch.rand(fs.bmass.shape, generator=gen, device=device)
               < push) & (fs.bmass > 0)
        bpos[0] += torch.where(sel, 2.5, 0.0)
    return bpos, fs.bmass, live_counts(fs.bmass)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("push", [0.0, 0.05])
def test_cic_deposit_kernel(cuda_device, push):
    box, ncell, ng = 32.0, 8, 32
    pos, m = uniform_particles(20000, box, 0)
    bpos, bmass, counts = _state(cuda_device, pos, m, box, ncell, 128, push)
    geo = dict(ncell=ncell, ng=ng, box_size=box)
    before = pm_rods.launches["cic_deposit"]
    grid, drop = pm_rods.cic_deposit(bpos, bmass, counts, **geo)
    assert pm_rods.launches["cic_deposit"] == before + 1
    ref, rdrop = pm_rods.cic_deposit_plain(bpos, bmass, counts, **geo)
    torch.cuda.synchronize()
    # each grid point sums the same float32 terms as plain in another
    # order (global adds as they land; a dense tile's part summed exactly
    # in its window and rounded once): a few ulps of a point's sum
    assert _rel(grid, ref) < 1e-5
    assert int(drop) == int(rdrop)
    assert (int(drop) > 0) == (push > 0)


def test_fd4_gather_kernel(cuda_device):
    box, ncell, ng = 32.0, 8, 32
    pos, m = uniform_particles(20000, box, 1)
    bpos, bmass, counts = _state(cuda_device, pos, m, box, ncell, 128, 0.05)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    phi = torch.randn((ng, ng, ng), generator=gen, device=cuda_device)
    geo = dict(ncell=ncell, ng=ng, box_size=box)
    got = pm_rods.fd4_gather(phi, bpos, counts, **geo)
    ref = pm_rods.fd4_gather_plain(phi, bpos, counts, **geo)
    torch.cuda.synchronize()
    # the differences are taken per corner instead of on whole grids
    assert _rel(got, ref) < 1e-5
    live = torch.arange(128, device=cuda_device)[None] < counts[:, None]
    assert bool(torch.all(got[:, ~live] == 0))


def _pm_kernels_vs_plain(device, bpos, bmass, counts, ncell, ng, box):
    """K1 and K2 against their plain versions: the existing bars (1e-5 of
    the largest value), plain's drop count, 0 on every dead and dropped
    slot."""
    geo = dict(ncell=ncell, ng=ng, box_size=box)
    grid, drop = pm_rods.cic_deposit(bpos, bmass, counts, **geo)
    ref, rdrop = pm_rods.cic_deposit_plain(bpos, bmass, counts, **geo)
    gen = torch.Generator(device=device).manual_seed(3)
    phi = torch.randn((ng, ng, ng), generator=gen, device=device)
    got = pm_rods.fd4_gather(phi, bpos, counts, **geo)
    gref = pm_rods.fd4_gather_plain(phi, bpos, counts, **geo)
    torch.cuda.synchronize()
    assert _rel(grid, ref) < 1e-5
    assert int(drop) == int(rdrop) > 0
    assert _rel(got, gref) < 1e-5
    assert bool(torch.all(got[gref == 0] == 0))
    cap = bmass.shape[1]
    live = torch.arange(cap, device=device)[None] < counts[:, None]
    assert bool(torch.all(got[:, ~live] == 0))


@pytest.mark.parametrize("ncell,ng", [(8, 32), (5, 40)])
def test_pm_kernels_heavy_cell(cuda_device, ncell, ng):
    """A cell of over 5,000 rows (capacity 8192): K1 sums its tile in the
    tile's window, K2 walks it in one block's loop; tiles of 2^3 cells
    (ncell 8) and of one (ncell 5)."""
    box = 32.0
    centre = (box / ncell) * (ncell // 2 + 0.5)
    pos, m = clustered_particles(20000, box, 5, n_clump=6000, sigma=0.3,
                                 centre=(centre,) * 3)
    bpos, bmass, counts = _state(cuda_device, pos, m, box, ncell, 8192,
                                 0.05)
    assert int(counts.max()) > 5000
    _pm_kernels_vs_plain(cuda_device, bpos, bmass, counts, ncell, ng, box)


@pytest.mark.parametrize("ncell,ng,cap,windowed,staged", [
    (2, 32, 4096, False, True), (1, 40, 20480, False, False),
    (3, 27, 1024, True, True), (3, 51, 1024, False, True)])
def test_pm_kernels_other_paths(cuda_device, ncell, ng, cap, windowed,
                                staged):
    """Geometries that take the kernels' other paths (pm_rods.tile_plan):
    K1 pushing rows to the grid where no window fits (ppc 16, 40, 17), K2
    reading the potential from global memory where its window does not
    fit (ncell 1: 48^3 points), and odd ng (27, 51: K1's scalar adds
    instead of pairs, from its window and from pushed rows)."""
    box = 32.0
    tp = pm_rods.tile_plan(ncell, ng)
    assert (tp["deposit_windowed"], tp["gather_staged"]) == (windowed,
                                                             staged)
    pos, m = uniform_particles(20000, box, 7)
    bpos, bmass, counts = _state(cuda_device, pos, m, box, ncell, cap,
                                 0.05)
    _pm_kernels_vs_plain(cuda_device, bpos, bmass, counts, ncell, ng, box)


def test_pm_kernels_mostly_dead(cuda_device):
    """Capacity 1024 for ~39 live rows a cell: 96% dead slots, which no
    thread walks and which K2 writes as 0."""
    box, ncell, ng = 32.0, 8, 32
    pos, m = uniform_particles(20000, box, 6)
    bpos, bmass, counts = _state(cuda_device, pos, m, box, ncell, 1024,
                                 0.05)
    assert float(counts.sum()) < 0.05 * counts.numel() * 1024
    _pm_kernels_vs_plain(cuda_device, bpos, bmass, counts, ncell, ng, box)


@pytest.mark.parametrize("clustered", [False, True])
def test_short_range_kernel(cuda_device, clustered):
    """Uniform at capacity 64 and a clump of 3000 in one cell (capacity
    4096: more live i than a block's threads, more j than one tile)."""
    box, ncell = 40.0, 5
    if clustered:
        pos, m = clustered_particles(12000, box, 3, n_clump=3000,
                                     sigma=1.0, centre=(20.0, 20.0, 20.0))
        cap = 4096
    else:
        pos, m = uniform_particles(4000, box, 4)
        cap = 64
    bpos, bmass, counts = _state(cuda_device, pos, m, box, ncell, cap)
    kw = dict(ncell=ncell, capacity=cap, box_size=box, rs=1.5,
              softening=0.1)
    got = short_range.short_range(bpos, bmass, counts, **kw)
    ref = short_range.short_range_plain(bpos, bmass, counts, **kw)
    torch.cuda.synchronize()
    # the kernel contracts r^2 and the polynomial into FMAs
    assert _rel(got, ref) < 1e-4
    if clustered:
        assert int(counts.max()) > 2500


# K3's split forms against their plain version: the kernels read 3.3e-6
# and 3.4e-6 of the max on the treepm_1m state (H100), while two split
# forms differ by 3.7e-5 or more (vpu2 against vpu3 there), so a launch of
# the wrong form fails this bar
SPLIT_FORM_TOL = 2e-5


@pytest.mark.parametrize("variant", ["vpu", "vpu2", "mxu"])
def test_short_range_split_forms(cuda_device, variant):
    """K3 with the factored-r (vpu2) and x-space (vpu, mxu) split on the
    stepper's live-first counts; given no counts, the same result bit for
    bit, and each slot's result unchanged when the live slots are
    scattered among the dead ones."""
    box, ncell, cap = 40.0, 5, 64
    pos, m = uniform_particles(4000, box, 4)
    bpos, bmass, counts = _state(cuda_device, pos, m, box, ncell, cap)
    kw = dict(ncell=ncell, capacity=cap, box_size=box, rs=1.5,
              softening=0.1, variant=variant)
    key = short_range.counter(variant)
    before = short_range.launches[key]
    got = short_range.short_range(bpos, bmass, counts, **kw)
    assert short_range.launches[key] == before + 1
    ref = short_range.short_range_plain(bpos, bmass, counts, **kw)
    no_counts = short_range.short_range(bpos, bmass, None, **kw)
    torch.cuda.synchronize()
    assert _rel(got, ref) < SPLIT_FORM_TOL
    assert bool(torch.all(got[:, bmass == 0] == 0))
    assert torch.equal(no_counts, got)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    perm = torch.argsort(torch.rand(bmass.shape, generator=gen,
                                    device=cuda_device), dim=1)
    sb = torch.gather(bpos, 2, perm[None].expand(3, -1, -1)).contiguous()
    sm = torch.gather(bmass, 1, perm).contiguous()
    shuffled = short_range.short_range(sb, sm, None, **kw)
    back = torch.empty_like(shuffled)
    back.scatter_(2, perm[None].expand(3, -1, -1), shuffled)
    torch.cuda.synchronize()
    assert _rel(back, got) < 1e-5


@pytest.mark.parametrize("variant", ["vpu3", "vpu2", "vpu"])
def test_short_range_heavy_cell(cuda_device, variant):
    """K3 in each split form on a clump of 5000 in one cell (capacity
    8192: 157 units of that cell): against plain on every live slot at
    1e-4, dead slots zero, two calls equal bit for bit; the card's plan
    equals unit_plan_plain."""
    box, ncell, cap = 40.0, 5, 8192
    pos, m = clustered_particles(14000, box, 6, n_clump=5000, sigma=0.6,
                                 centre=(20.0, 20.0, 20.0))
    bpos, bmass, counts = _state(cuda_device, pos, m, box, ncell, cap)
    assert int(counts.max()) > 4096
    plan = short_range.unit_plan(counts, ncell)
    ref_plan = short_range.unit_plan_plain(counts.cpu(), ncell)
    n_live = int(ref_plan[1])
    base = short_range.PLAN_HEADER + ncell ** 3
    for lo, hi in ((0, base + n_live), (base + ncell ** 3,
                                        base + ncell ** 3 + n_live)):
        assert torch.equal(plan[lo:hi].cpu(), ref_plan[lo:hi])
    kw = dict(ncell=ncell, capacity=cap, box_size=box, rs=1.5,
              softening=0.1, variant=variant)
    got = short_range.short_range(bpos, bmass, counts, **kw)
    again = short_range.short_range(bpos, bmass, counts, **kw)
    ref = short_range.short_range_plain(bpos, bmass, counts, **kw)
    torch.cuda.synchronize()
    assert _rel(got, ref) < 1e-4
    assert torch.equal(got, again)
    assert bool(torch.all(got[:, bmass == 0] == 0))


@pytest.mark.parametrize("edges", [False, True])
def test_short_range_rd_kernel(cuda_device, edges):
    """K8 on 20,000 particles in 4^2 rods of 2048 slots (r_cut 9, rods 16
    wide); with edges=True half of them in thin z slabs at both faces."""
    box, ncell, rs, soft = 64.0, 4, 2.0, 0.1
    pos, m = uniform_particles(20000, box, 6)
    if edges:
        z = np.random.default_rng(6).uniform(0.0, 3.0, 10000)
        pos[:10000, 2] = np.where(np.arange(10000) % 2 == 0, z, box - z)
    k_rod = short_range_rd.rd_geometry(20000, ncell)
    rpos, rmass, counts, rzq, ovf, _ = short_range_rd.rd_pack(
        tt(pos).to(cuda_device), tt(m).to(cuda_device), box, ncell=ncell,
        k_rod=k_rod)
    assert int(ovf) == 0
    tables = short_range_rd.rd_window_tables(rzq, counts, ncell=ncell,
                                             k_rod=k_rod, box_size=box,
                                             window=4.5 * rs)
    kw = dict(ncell=ncell, k_rod=k_rod, box_size=box, rs=rs, softening=soft)
    before = short_range_rd.launches["short_range_rd"]
    got = short_range_rd.short_range_rd(rpos, rmass, counts, tables, **kw)
    assert short_range_rd.launches["short_range_rd"] == before + 1
    ref = short_range_rd.short_range_rd_plain(rpos, rmass, counts, tables,
                                              **kw)
    torch.cuda.synchronize()
    assert _rel(got, ref) < 1e-4
    live = torch.arange(k_rod, device=cuda_device)[None] < counts[:, None]
    assert bool(torch.all(got[~live] == 0))


def _fof_inputs(device, ncell, cap, seed=7):
    """A clustered box bucketed for the FoF hook, with a few inactive
    cells: (bx, by, bz, slot labels, counts, active, n, box, b)."""
    box, b = 20.0, 0.3
    pos, _ = clustered_particles(6000, box, seed, n_clump=2500, sigma=0.4,
                                 centre=(10.0, 10.0, 10.0))
    n = pos.shape[0]
    bxyz, _, counts, pslot, _, ovf = halo_finder._fof_setup(
        tt(pos).to(device), torch.ones(n, dtype=torch.bool, device=device),
        box, ncell, cap)
    assert int(ovf) == 0
    nslots = ncell ** 3 * cap
    lab = torch.full((nslots + 1,), n, dtype=torch.int32, device=device)
    rng = np.random.default_rng(seed)
    plab = torch.tensor(rng.permutation(n).astype(np.int32), device=device)
    lab[torch.where(pslot >= 0, pslot, nslots)] = plab
    active = torch.tensor(rng.random(ncell ** 3) < 0.9, device=device
                          ).to(torch.int32)
    return (*bxyz, lab[:nslots].reshape(ncell ** 3, cap), counts, active,
            n, box, b)


@pytest.mark.parametrize("ncell,cap", [(16, 2048), (2, 4096)])
def test_fof_hook_kernel(cuda_device, ncell, cap):
    """One full sweep, kernel against plain: exactly equal labels, dead
    rows and inactive cells untouched (more live rows in the clump's
    cells than a block holds; a lattice of two cells, where neighbours
    alias under several shifts)."""
    bx, by, bz, lab, counts, active, n, box, b = _fof_inputs(
        cuda_device, ncell, cap)
    kw = dict(ncell=ncell, capacity=cap, n_sentinel=n, box_size=box,
              linking_length=b)
    before = fof_hook.launches["fof_hook"]
    got = fof_hook.fof_hook(bx, by, bz, lab, counts, active, **kw)
    assert fof_hook.launches["fof_hook"] == before + 1
    ref = fof_hook.fof_hook_plain(bx, by, bz, lab, counts, active, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert int((got != lab).sum()) > 0
    assert int(counts.max()) > fof_hook.THREADS


def test_fof_labels_card_matches_cpu(cuda_device):
    """fof_labels through K5 on the card against the plain version on
    the CPU, with overflow and dead rows: exactly equal labels."""
    box = 20.0
    pos, _ = clustered_particles(8000, box, 9, n_clump=3000, sigma=0.3,
                                 centre=(11.25, 11.25, 11.25))
    live = np.ones(len(pos), bool)
    live[-50:] = False
    b = 0.25 * box / len(pos) ** (1 / 3)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        p = tt(pos).to(dev)
        plan = halo_finder.fof_plan(len(pos), box, b, positions=p,
                                    live=torch.tensor(live, device=dev))
        out.append(halo_finder.fof_labels(
            p, box, b, ncell=8, capacity=512, live=torch.tensor(
                live, device=dev)))
        assert plan["ncell"] >= 1
    (lg, og), (lc, oc) = out
    assert torch.equal(lg.cpu(), lc)
    assert int(og) == int(oc) > 0


def test_stepper_on_card_matches_cpu(cuda_device):
    box, ng = 50.0, 32
    pos, m = uniform_particles(8000, box, 5)
    vel = np.random.default_rng(6).normal(size=pos.shape).astype(np.float32)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        fs, kw = fast_treepm.initialize_fast(
            tt(pos).to(dev), tt(vel).to(dev), tt(m).to(dev), 0.1,
            box_size=box, pm_grid=ng, softening=0.1, kick_mode="comoving")
        fs = fast_treepm.fast_run(fs, CosmologyParams(), 1e-5, n_steps=6,
                                  rebucket_every=3, **kw)
        out.append(fs)
    g, c = out
    assert torch.equal(g.ids.cpu(), c.ids)
    assert _rel(g.bpos.cpu(), c.bpos) < 1e-6
    assert _rel(g.bvel.cpu(), c.bvel) < 1e-4
    assert int(g.dropped) == int(c.dropped)
    assert int(g.overflow) == int(c.overflow)


def test_compact_rebucket_on_card(cuda_device):
    """The compact rebucket of a sparse layout (C*K > 4 n_rows, as
    grow-and-retry leaves it) on the card: field by field equal to the
    gather form on the card, and to the compact form on the CPU (ids and
    masses exactly, positions to an ulp of the wrap)."""
    n, box, ncell, cap = 1200, 24.0, 8, 16
    pos, m = uniform_particles(n, box, 3)
    vel = np.random.default_rng(3).normal(size=(n, 3)).astype(np.float32)
    plan = {"ncell": ncell, "capacity": cap, "margin": 1, "rs": 1.0}
    kw = dict(box_size=box, ncell=ncell, capacity=cap)
    assert ncell ** 3 * cap > 4 * n
    drift = None
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        fs = fast_treepm.build_fast_state(tt(pos).to(dev), tt(vel).to(dev),
                                          tt(m).to(dev), 0.25, box_size=box,
                                          plan=plan)
        if drift is None:
            drift = np.random.default_rng(9).normal(
                scale=2.0, size=tuple(fs.bpos.shape)).astype(np.float32)
        fs = fs.replace(bpos=torch.where((fs.bmass > 0)[None],
                                         fs.bpos + tt(drift).to(dev), 0.0))
        out[dev.type] = fast_treepm._rebucket(fs, n_rows=n, **kw)
        if dev.type == "cuda":
            gather = fast_treepm._rebucket(fs, **kw)
    g, c = out["cuda"], out["cpu"]
    for name in ("bpos", "bvel", "acc", "bmass", "ids", "overflow"):
        assert torch.equal(getattr(g, name), getattr(gather, name)), name
    assert torch.equal(g.ids.cpu(), c.ids)
    assert torch.equal(g.bmass.cpu(), c.bmass)
    assert torch.equal(g.bvel.cpu(), c.bvel)
    assert _rel(g.bpos.cpu(), c.bpos) < 1e-6
    assert int(g.overflow) == int(c.overflow) == 0


# K4/K4s against their plain versions on the card: the same arithmetic,
# sums in another order and with FMAs; 1e-5 of the largest |a| for every
# variant, the JAX package's bar for its kernel (read at 100k on the H100:
# at most 1.5e-6)
DIRECT_TOL = 1e-5


@pytest.mark.parametrize("variant", direct.VARIANTS)
@pytest.mark.parametrize("n", [200, 333, 5000])
def test_direct_kernel(cuda_device, n, variant):
    """Two and three K4 tiles with a ragged edge, and 5000 particles
    (K4s: 21 tiles, the wrap), periodic and not."""
    box = 20.0
    pos, m = uniform_particles(n, box, n)
    p, mm = tt(pos).to(cuda_device), tt(m).to(cuda_device)
    for periodic in (True, False):
        key = "direct_sym" if variant.startswith("sym") else "direct"
        before = direct.launches[key]
        got = direct.pairwise_accelerations(p, mm, box, 0.05, 2.0,
                                            periodic=periodic,
                                            variant=variant)
        assert direct.launches[key] == before + 1
        ref = direct.pairwise_accelerations_plain(p, mm, box, 0.05, 2.0,
                                                  periodic=periodic,
                                                  variant=variant)
        torch.cuda.synchronize()
        assert _rel(got, ref) < DIRECT_TOL


@pytest.mark.parametrize("variant", ["v1", "sym"])
def test_direct_kernel_half_box_image(cuda_device, variant):
    """Pairs one ulp past half a box apart: K4 and K4s take the image of
    the true quotient d / box, as the plain version and the CPU solver
    do."""
    box = 50.0
    pos, m, flips = half_box_lattice(box, seed=3)
    assert flips > 0
    got = direct.pairwise_accelerations(tt(pos).to(cuda_device),
                                        tt(m).to(cuda_device), box, 0.1,
                                        variant=variant)
    ref = direct.pairwise_accelerations_plain(tt(pos), tt(m), box, 0.1,
                                              variant=variant)
    assert _rel(got.cpu(), ref) < DIRECT_TOL


@pytest.mark.parametrize("n", [1, 200, 333, 5000])
def test_pair_potential_kernel(cuda_device, n):
    """K9 against its plain version at 1e-6 (float32 pair terms, float64
    sums in another order), the same U from two calls, one launch each;
    potential_energy routes CUDA tensors to K9."""
    box = 20.0
    p, mm = uniform_particles(n, box, n)
    p, mm = tt(p).to(cuda_device), tt(mm).to(cuda_device)
    before = direct.launches["pair_potential"]
    got = direct.pair_potential(p, mm, box, 0.05, 2.0)
    again = direct.pair_potential(p, mm, box, 0.05, 2.0)
    assert direct.launches["pair_potential"] == before + 2
    assert got.dtype == torch.float64 and float(got) == float(again)
    ref = direct.pair_potential_plain(p, mm, box, 0.05, 2.0)
    assert abs(float(got) - float(ref)) <= 1e-6 * max(abs(float(ref)),
                                                      1e-300)
    pe = potential_energy(p, mm, box, 0.05, 2.0)
    assert direct.launches["pair_potential"] == before + 3
    assert pe.dtype == torch.float32 and float(pe) == float(
        got.to(torch.float32))


@pytest.mark.parametrize("n, soft", [(3 * direct.PAIR_TILE + 77, 0.05),
                                     (20000, 0.05), (2, 0.0),
                                     (3 * direct.PAIR_TILE + 77, 0.0)])
def test_pair_potential_deterministic(cuda_device, n, soft):
    """K9 on several tiles with a partial last one (clustered); at
    softening 0 a quarter of the particles and the last one sit on
    others, so those pairs and the self pairs have r^2 = 0 and are left
    out: two calls give the same finite U bit for bit, within 1e-6 of
    plain."""
    pos, m = clustered_particles(n, 30.0, n, n_clump=n // 3, sigma=0.5,
                                 centre=(15.0, 15.0, 15.0))
    if soft == 0.0:
        pos[n // 2:n // 2 + n // 4] = pos[:n // 4]
        pos[-1] = pos[0]
    p, mm = tt(pos).to(cuda_device), tt(m).to(cuda_device)
    got = [float(direct.pair_potential(p, mm, 30.0, soft)) for _ in
           range(2)]
    ref = float(direct.pair_potential_plain(p, mm, 30.0, soft))
    assert math.isfinite(got[0]) and got[0] == got[1]
    assert abs(got[0] - ref) <= 1e-6 * abs(ref)


def test_pair_potential_half_box_image(cuda_device):
    """Pairs one ulp past half a box apart: K9 rounds d * (1/box), not the
    true quotient its plain version rounds, and may take the other image;
    at that tie both images have the same |d| to an ulp, so U holds plain
    at 1e-6."""
    pos, m, flips = half_box_lattice(50.0, seed=3, side=16)
    assert flips > 0
    p, mm = tt(pos).to(cuda_device), tt(m).to(cuda_device)
    got = float(direct.pair_potential(p, mm, 50.0, 0.05))
    ref = float(direct.pair_potential_plain(p, mm, 50.0, 0.05))
    assert abs(got - ref) <= 1e-6 * abs(ref)


def test_alias_probe_kernel(cuda_device):
    """K10: the sequential mode gives 1..8 in column 0 (and in every
    column); the blocks mode runs, whatever order the card gives it:
    row 0 reads itself, so it is 1, and no row exceeds 8."""
    before = alias_probe.launches["alias_probe"]
    x = alias_probe.alias_probe(torch.zeros((8, 128), device=cuda_device),
                                "sequential")
    ref = alias_probe.alias_probe_plain(torch.zeros((8, 128)), True)
    torch.cuda.synchronize()
    assert torch.equal(x.cpu(), ref)
    assert x[:, 0].tolist() == [float(i) for i in range(1, 9)]
    y = alias_probe.alias_probe(torch.zeros((8, 128), device=cuda_device),
                                "blocks")
    torch.cuda.synchronize()
    assert alias_probe.launches["alias_probe"] == before + 2
    assert float(y[0, 0]) == 1.0 and float(y.max()) <= 8.0
    assert float(y.min()) >= 1.0


def test_direct_solver_on_card(cuda_device):
    """The `direct` solver on a CUDA state launches K4 once and agrees
    with the CPU path; softening 0 raises on the card too."""
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.core.state import make_state
    from lambda_cdm_tpu_torch.forces import create_force_computer
    cfg = SimulationConfig.from_dict(
        {"particles": {"num_particles": 3000, "box_size": 30.0},
         "forces": {"type": "direct", "softening_length": 0.1}})
    pos, m = uniform_particles(3000, 30.0, 8)
    fn = create_force_computer(cfg)
    before = direct.launches["direct"]
    got = fn(make_state(pos, np.zeros_like(pos), m, device=cuda_device))
    assert direct.launches["direct"] == before + 1
    ref = fn(make_state(pos, np.zeros_like(pos), m))
    assert _rel(got.cpu(), ref) < 1e-5
    with pytest.raises(ValueError, match="softening"):
        direct.pairwise_accelerations(tt(pos).to(cuda_device),
                                      tt(m).to(cuda_device), 30.0, 0.0)


def test_glass_relax_on_card(cuda_device):
    """Glass relaxation on the card goes through K4, one launch an
    iteration, and lands where the CPU's row-blocked sum does: 1e-5 of
    the box after 5 iterations."""
    from lambda_cdm_tpu_torch.physics.initial_conditions import glass_relax
    box = 20.0
    start = tt(np.random.default_rng(17).uniform(0.0, box, (343, 3)))
    before = direct.launches["direct"]
    got = glass_relax(start.to(cuda_device), box, iterations=5)
    assert direct.launches["direct"] == before + 5
    ref = glass_relax(start, box, iterations=5)
    d = torch.remainder(got.cpu() - ref + box / 2, box) - box / 2
    assert float(d.abs().max()) < 1e-5 * box


@pytest.mark.parametrize("n_fields,ng,n_rays", [(3, 256, 65536),
                                                (6, 256, 4096),
                                                (3, 100, 700)])
def test_lens_sample_kernel(cuda_device, n_fields, ng, n_rays):
    """K6 equals its plain version bit for bit (the kernel combines the
    weights in the plain version's order without FMAs); points on the
    periodic edges and, at ng 100, a grid that is no power of two."""
    rng = np.random.default_rng(ng + n_fields)
    ext = 37.5
    fields = tt(rng.standard_normal((n_fields, ng, ng))).to(cuda_device)
    xy = rng.uniform(0, ext, (n_rays, 2))
    xy[:4] = [[0.0, 0.0], [ext, ext], [ext - 1e-4, 0.0], [ext / 2, ext]]
    xy = tt(xy).to(cuda_device)
    before = lens_sample.launches["lens_sample"]
    got = lens_sample.bilinear_sample_fields(fields, xy, ext)
    assert lens_sample.launches["lens_sample"] == before + 1
    ref = lens_sample.bilinear_sample_fields_plain(fields, xy, ext)
    torch.cuda.synchronize()
    assert got.shape == (n_fields, n_rays)
    assert torch.equal(got, ref)


def test_lens_sample_xwin_kernel(cuda_device):
    """K7: x unwrapped (negative and past the box), y past the box too;
    equal to the plain version on the same unwrapped input, and within
    float32 round-off of K6 on the wrapped input."""
    rng = np.random.default_rng(3)
    ng, ext, n = 256, 100.0, 3000
    fields = tt(rng.standard_normal((3, ng, ng))).to(cuda_device)
    x = (-0.3 + 1.5 * np.arange(n) / n) * ext
    xy = tt(np.stack([x, rng.uniform(-0.1, 1.1, n) * ext], 1)) \
        .to(cuda_device)
    before = lens_sample.launches["lens_sample_xwin"]
    got = lens_sample.bilinear_sample_fields_xwin(fields, xy, ext,
                                                  window=64)
    assert lens_sample.launches["lens_sample_xwin"] == before + 1
    assert torch.equal(got, lens_sample.bilinear_sample_fields_plain(
        fields, xy, ext))
    wrapped = lens_sample.bilinear_sample_fields(
        fields, torch.remainder(xy, ext), ext)
    assert _rel(got, wrapped) < 1e-4
    with pytest.raises(ValueError, match="window"):
        lens_sample.bilinear_sample_fields_xwin(fields, xy, ext, window=250)


@pytest.mark.parametrize("window", [0, 40])
def test_trace_rays_on_card_matches_cpu(cuda_device, window):
    """The bench accuracy geometry cut to 4 planes and 64^2 rays: the
    card's trace (K6, or K7 with a window) against the CPU's, kappa within
    1e-3 of its largest value (the maps bar); one launch a plane."""
    from lambda_cdm_tpu_torch.raytracing import lensing
    rng = np.random.default_rng(4)
    ng, box, L = 256, 100.0, 4
    planes = tt(0.2 * rng.standard_normal((L, ng, ng)))
    chis = tt(np.linspace(400.0, 1100.0, L))
    a_l = tt(np.linspace(0.9, 0.7, L))
    ang = (np.arange(64) + 0.5) * (box / 2000.0) / 64
    theta0 = tt(np.stack(np.meshgrid(ang, ang, indexing="ij"),
                         -1).reshape(-1, 2))
    p = CosmologyParams()
    ref = lensing.trace_rays(p, planes, chis, a_l, 100.0, box, theta0,
                             2500.0, ng=ng, jacobian=True)
    name = "lens_sample_xwin" if window else "lens_sample"
    before = lens_sample.launches[name]
    got = lensing.trace_rays(p, planes.to(cuda_device), chis, a_l, 100.0,
                             box, theta0.to(cuda_device), 2500.0, ng=ng,
                             jacobian=True, window=window)
    assert lens_sample.launches[name] == before + L
    assert _rel(got.kappa.cpu(), ref.kappa) < 1e-3
    assert _rel(got.kappa_jac.cpu(), ref.kappa_jac) < 1e-3
