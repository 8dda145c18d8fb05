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

from _torch_parity import K8_STAGE_TILES, clustered_particles, \
    cuda_device, half_box_lattice, k8_union_tiles, tt, \
    uniform_particles  # noqa: F401  (a fixture)

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
    assert int(counts.max()) > short_range.UNIT_ROWS
    cap_rows = torch.arange(cap, device=cuda_device)[None]
    off = (active == 0)[:, None] | (cap_rows >= counts[:, None])
    assert torch.equal(got[off], lab[off])


def test_fof_hook_kernel_late_round(cuda_device):
    """K5 on the state of fof_labels' last round that still changes a
    label (most labels are their component's least index, the active
    mask has shrunk): equal to the plain version; two calls equal."""
    ncell, cap, box, b = 16, 2048, 20.0, 0.3
    pos, _ = clustered_particles(6000, box, 7, n_clump=2500, sigma=0.4,
                                 centre=(10.0, 10.0, 10.0))
    n = pos.shape[0]
    bxyz, _, counts, pslot, _, _ = halo_finder._fof_setup(
        tt(pos).to(cuda_device), torch.ones(n, dtype=torch.bool,
                                            device=cuda_device),
        box, ncell, cap)
    state = (torch.arange(n, device=cuda_device),
             torch.ones(ncell ** 3, dtype=torch.int32, device=cuda_device))
    late = None
    while True:
        nxt, changed, act = halo_finder._fof_round(
            state[0], bxyz, counts, pslot, box_size=box, linking_length=b,
            ncell=ncell, capacity=cap, hook_fn=fof_hook.fof_hook,
            active=state[1])
        if not bool(changed):
            break
        late, state = state, (nxt, act)
    lab_p, active = late
    assert 0 < int(active.sum()) < ncell ** 3
    nslots = ncell ** 3 * cap
    lab = torch.full((nslots + 1,), n, dtype=torch.int32, device=cuda_device)
    lab[torch.where(pslot >= 0, pslot, nslots)] = lab_p.to(torch.int32)
    lab = lab[:nslots].reshape(ncell ** 3, cap)
    kw = dict(ncell=ncell, capacity=cap, n_sentinel=n, box_size=box,
              linking_length=b)
    got = fof_hook.fof_hook(*bxyz, lab, counts, active, **kw)
    again = fof_hook.fof_hook(*bxyz, lab, counts, active, **kw)
    ref = fof_hook.fof_hook_plain(*bxyz, lab, counts, active, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got, again)
    assert int((got != lab).sum()) > 0


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


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("n", [77, 10_648, 100_000])
def test_direct_kernel_slices(cuda_device, n, variant):
    """K4 where its j slices change: below one tile (S = 1), direct_10k's
    10,648 (S = 17) and 100k (S = 1), periodic and not, against the plain
    version; two calls give equal bytes."""
    box = 20.0
    pos, m = uniform_particles(n, box, n + 1)
    p, mm = tt(pos).to(cuda_device), tt(m).to(cuda_device)
    assert (direct.j_slices(n) > 1) == (n == 10_648)
    for periodic in (True, False):
        kw = dict(periodic=periodic, variant=variant)
        got = direct.pairwise_accelerations(p, mm, box, 0.05, 2.0, **kw)
        again = direct.pairwise_accelerations(p, mm, box, 0.05, 2.0, **kw)
        ref = direct.pairwise_accelerations_plain(p, mm, box, 0.05, 2.0,
                                                  **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert _rel(got, ref) < DIRECT_TOL
    direct.check_range()


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_direct_kernel_range_flag(cuda_device, variant):
    """A position 2^21 boxes or more from the origin, where the magic
    rounding of the image may be off, sets the flag on the card: the call
    itself returns, check_range raises and clears it; a call in range
    leaves it clear."""
    box = 10.0
    pos, m = uniform_particles(300, box, 5)
    p, mm = tt(pos).to(cuda_device), tt(m).to(cuda_device)
    direct.check_range()
    direct.pairwise_accelerations(p, mm, box, 0.1, variant=variant)
    direct.check_range()
    far = p.clone()
    far[17, 1] = direct.PAIR_POSITION_LIMIT * box * 1.5
    direct.pairwise_accelerations(far, mm, box, 0.1, variant=variant)
    with pytest.raises(ValueError, match="boxes"):
        direct.check_range()
    direct.check_range()
    direct.pairwise_accelerations(far, mm, box, 0.1, periodic=False,
                                  variant=variant)
    direct.check_range()


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


@pytest.mark.parametrize("variant", ["sym", "sym2"])
@pytest.mark.parametrize("n", [1, 2, 31, 33, direct.SYM_TILE - 1,
                               direct.SYM_TILE + 1])
def test_direct_sym_small(cuda_device, n, variant):
    """K4s below one warp's columns, around one tile (257: two tiles and
    the odd count's pad), periodic and not, one launch a call, with two
    zero-mass rows (their result exactly 0) where n allows."""
    box = 20.0
    pos, m = uniform_particles(n, box, n + 7)
    if n > 2:
        m[[0, n - 1]] = 0.0
    p, mm = tt(pos).to(cuda_device), tt(m).to(cuda_device)
    for periodic in (True, False):
        before = direct.launches["direct_sym"]
        got = direct.pairwise_accelerations(p, mm, box, 0.05, 2.0,
                                            periodic=periodic,
                                            variant=variant)
        assert direct.launches["direct_sym"] == before + 1
        ref = direct.pairwise_accelerations_plain(p, mm, box, 0.05, 2.0,
                                                  periodic=periodic,
                                                  variant=variant)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        if n > 2:
            assert bool(torch.all(got[[0, n - 1]] == 0))
        if n == 1:
            assert bool(torch.all(got == 0))
        else:
            assert _rel(got, ref) < DIRECT_TOL


@pytest.mark.parametrize("variant", ["sym", "sym2"])
@pytest.mark.parametrize("n, blocks", [(2100, 27), (5000, None),
                                       (100_000, None)])
def test_direct_sym_runs(cuda_device, n, blocks, variant, monkeypatch):
    """K4s where a tile's k are cut into runs: 2100 particles in runs of
    1, 2 and 2 k (SYM_BLOCKS 27), 5000 (one k a run), 100k (runs of 7 and
    8), periodic and not, against the plain version; two calls give equal
    bytes."""
    if blocks is not None:
        monkeypatch.setattr(direct, "SYM_BLOCKS", blocks)
    assert direct.sym_runs(n) > 1
    box = 20.0
    pos, m = uniform_particles(n, box, n + 3)
    p, mm = tt(pos).to(cuda_device), tt(m).to(cuda_device)
    for periodic in (True, False):
        kw = dict(periodic=periodic, variant=variant)
        got = direct.pairwise_accelerations(p, mm, box, 0.05, 2.0, **kw)
        again = direct.pairwise_accelerations(p, mm, box, 0.05, 2.0, **kw)
        ref = direct.pairwise_accelerations_plain(p, mm, box, 0.05, 2.0,
                                                  **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert _rel(got, ref) < DIRECT_TOL


@pytest.mark.parametrize("variant", ["sym", "sym2"])
@pytest.mark.parametrize("spread", ["all", "some"])
def test_direct_sym_exact_image(cuda_device, variant, spread):
    """Positions over three boxes (every warp), or the last 40 particles
    two boxes out (the warps that meet them): K4s takes the quotient and
    rintf where a tile's positions span more than 1.5 boxes, and holds its
    plain version there too."""
    n, box = 3000, 20.0
    pos, m = uniform_particles(n, box, 17)
    if spread == "all":
        pos = pos * np.float32(3.0) - np.float32(box)
    else:
        pos[-40:] += np.float32(2.0 * box)
    p, mm = tt(pos).to(cuda_device), tt(m).to(cuda_device)
    got = direct.pairwise_accelerations(p, mm, box, 0.05, 2.0,
                                        variant=variant)
    ref = direct.pairwise_accelerations_plain(p, mm, box, 0.05, 2.0,
                                              variant=variant)
    assert _rel(got, ref) < DIRECT_TOL


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


@pytest.mark.parametrize("shape", [(8, 128), (5, 300), (1, 7)])
def test_alias_probe_sequential_random(cuda_device, shape):
    """K10's sequential mode from a random nonzero buffer (from zeros many
    wrong kernels also give 1..8) equals alias_probe_plain bit for bit, at
    the probe's shape and at ragged ones (300 columns: three blocks)."""
    rng = np.random.default_rng(shape[1])
    x = rng.normal(size=shape).astype(np.float32) * np.float32(1e3)
    got = alias_probe.alias_probe(tt(x).to(cuda_device), "sequential")
    ref = alias_probe.alias_probe_plain(tt(x), True)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


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
    card's trace (the trace kernel on K6's route, or K7's with a window)
    against the CPU's, kappa within 1e-3 of its largest value (the maps
    bar); one launch of the trace kernel a trace."""
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
    name = "lens_trace_xwin" if window else "lens_trace"
    before = lens_sample.launches[name]
    got = lensing.trace_rays(p, planes.to(cuda_device), chis, a_l, 100.0,
                             box, theta0.to(cuda_device), 2500.0, ng=ng,
                             jacobian=True, window=window)
    assert lens_sample.launches[name] == before + 1
    assert _rel(got.kappa.cpu(), ref.kappa) < 1e-3
    assert _rel(got.kappa_jac.cpu(), ref.kappa_jac) < 1e-3


def _device_launches(fn, tries=4):
    """Device activities (kernels, copies, fills) of one fn() call as
    torch.profiler records them (a window with none recorded is taken
    again)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
        if n:
            return n
    return 0


@pytest.mark.parametrize("windowed", [False, True])
def test_lens_sample_one_launch(cuda_device, windowed):
    """K6 and K7 are one device launch a call (the kernel forms the grid
    coordinates), with the extent a 0-d tensor or a number, and equal
    their plain version bit for bit."""
    rng = np.random.default_rng(12)
    ng, ext = 256, 100.0
    fields = tt(rng.standard_normal((3, ng, ng))).to(cuda_device)
    xy = rng.uniform(0, ext, (65536, 2))
    if windowed:
        xy[:, 0] = xy[:, 0] * 1.4 - 20.0
    xy = tt(xy).to(cuda_device)
    ref = lens_sample.bilinear_sample_fields_plain(fields, xy, ext)
    for extent in (torch.tensor(ext, device=cuda_device), ext):
        def call():
            if windowed:
                return lens_sample.bilinear_sample_fields_xwin(
                    fields, xy, extent, window=64)
            return lens_sample.bilinear_sample_fields(fields, xy, extent)
        assert torch.equal(call(), ref)
        assert _device_launches(call) == 1


def _trace_inputs(device, ng=128, L=16, side=64, jacobian=True):
    """The lensing bench's geometry cut to 128^2 planes and 64^2 rays."""
    from lambda_cdm_tpu_torch.raytracing import lensing
    rng = np.random.default_rng(ng + L)
    planes = tt(0.2 * rng.standard_normal((L, ng, ng))).to(device)
    chis = torch.linspace(400.0, 1900.0, L, device=device)
    a_l = torch.linspace(0.9, 0.55, L, device=device)
    ang = (np.arange(side) + 0.5) * (100.0 / 2000.0) / side
    theta0 = tt(np.stack(np.meshgrid(ang, ang, indexing="ij"),
                         -1).reshape(-1, 2)).to(device)
    p = CosmologyParams()
    fl = lensing.lens_plane_fields(p, planes, chis, a_l, 100.0, 100.0,
                                   2500.0, ng=ng, jacobian=jacobian)
    return p, planes, chis, a_l, theta0, fl


@pytest.mark.parametrize("jacobian", [False, True])
@pytest.mark.parametrize("window", [0, 40])
def test_trace_kernel_matches_plain(cuda_device, jacobian, window):
    """The trace kernel (one launch a trace) against its plain version run
    on the card from the same arrays: every output bit for bit; theta0 is
    not written; a planted x offset reaches the kernel."""
    from lambda_cdm_tpu_torch.raytracing import lensing
    p, _, chis, a_l, theta0, fl = _trace_inputs(cuda_device,
                                                jacobian=jacobian)
    chi_s = torch.tensor(2500.0, device=cuda_device)
    w = lensing.lensing_efficiency(p, chis, chi_s, a_l)
    before = theta0.clone()
    kw = dict(jacobian=jacobian, window=window)
    got = lens_sample.trace_planes(fl, theta0, chis, w, 100.0, 100.0, chi_s,
                                   **kw)
    ref = lens_sample.trace_planes_plain(
        fl, theta0, chis, w, 100.0, torch.tensor(100.0, device=cuda_device),
        chi_s, **kw)
    torch.cuda.synchronize()
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert torch.equal(theta0, before)
    moved = lens_sample.trace_planes(fl, theta0, chis, w, 100.0, 100.0,
                                     chi_s, x_offset=0.4, **kw)
    moved_ref = lens_sample.trace_planes_plain(
        fl, theta0, chis, w, 100.0, 100.0, chi_s, x_offset=0.4, **kw)
    assert torch.equal(moved["kappa"], moved_ref["kappa"])
    assert _rel(moved["kappa"], got["kappa"]) > 1e-3


@pytest.mark.parametrize("jacobian", [False, True])
@pytest.mark.parametrize("window", [0, 40])
def test_trace_kernel_zero_planes(cuda_device, jacobian, window):
    """No lens planes: the trace kernel still launches once and writes
    the unlensed bundle (theta0, kappa 0, A = I) into new buffers, equal
    to trace_planes_plain bit for bit."""
    p, _, chis, a_l, theta0, fl = _trace_inputs(cuda_device,
                                                jacobian=jacobian)
    fl, chis = fl[:0], chis[:0]
    w = torch.zeros(0, device=cuda_device)
    kw = dict(jacobian=jacobian, window=window)
    name = "lens_trace_xwin" if window else "lens_trace"
    before = lens_sample.launches[name]
    got = lens_sample.trace_planes(fl, theta0, chis, w, 100.0, 100.0, 2500.0,
                                   **kw)
    assert lens_sample.launches[name] == before + 1
    ref = lens_sample.trace_planes_plain(fl, theta0, chis, w, 100.0, 100.0,
                                         2500.0, **kw)
    torch.cuda.synchronize()
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert got["theta"].data_ptr() != theta0.data_ptr()
    assert bool(torch.all(got["kappa"] == 0))


@pytest.mark.parametrize("jacobian", [False, True])
def test_trace_rays_launches_a_plane(cuda_device, jacobian):
    """trace_rays given its plane fields (16 planes) issues at most 3
    device launches a plane, the trace kernel once."""
    from lambda_cdm_tpu_torch.raytracing import lensing
    p, planes, chis, a_l, theta0, fl = _trace_inputs(cuda_device,
                                                     jacobian=jacobian)
    w = lensing.auto_sample_window(fl, chis, theta0, 100.0, ng=128)
    name = "lens_trace_xwin" if w else "lens_trace"

    def trace():
        return lensing.trace_rays(p, planes, chis, a_l, 100.0, 100.0, theta0,
                                  2500.0, ng=128, jacobian=jacobian,
                                  window=w, fields_l=fl)
    before = lens_sample.launches[name]
    trace()
    assert lens_sample.launches[name] == before + 1
    n = _device_launches(trace)
    assert 0 < n <= 3 * planes.shape[0]


def _rd_inputs(device, scenario):
    """K8 on 20,000 particles in 4^2 rods (r_cut 9, rods 16 wide): with z
    edges half of them in thin z slabs at both faces; with a full rod,
    rod (0, 0) filled past its 2,048 slots."""
    box, ncell, rs = 64.0, 4, 2.0
    pos, m = uniform_particles(20000, box, 6)
    rng = np.random.default_rng(6)
    if scenario == "edges":
        z = rng.uniform(0.0, 3.0, 10000)
        pos[:10000, 2] = np.where(np.arange(10000) % 2 == 0, z, box - z)
    if scenario == "full":
        pos[:3000, :2] = rng.uniform(1.0, 15.0, (3000, 2))
    k_rod = short_range_rd.rd_geometry(20000, ncell)
    rpos, rmass, counts, rzq, _, _ = short_range_rd.rd_pack(
        tt(pos).to(device), tt(m).to(device), box, ncell=ncell, k_rod=k_rod)
    tables = short_range_rd.rd_window_tables(rzq, counts, ncell=ncell,
                                             k_rod=k_rod, box_size=box,
                                             window=4.5 * rs)
    kw = dict(ncell=ncell, k_rod=k_rod, box_size=box, rs=rs, softening=0.1)
    return rpos, rmass, counts, tables, kw


@pytest.mark.parametrize("scenario", ["edges", "full"])
def test_short_range_rd_kernel_schedules(cuda_device, scenario):
    """K8 on the z-edge case and a full rod, whose groups' unions take
    more than one stage buffer (the passes stream through both): two
    calls equal byte for byte, within 1e-4 of the plain version, dead
    slots 0."""
    rpos, rmass, counts, tables, kw = _rd_inputs(cuda_device, scenario)
    if scenario == "full":
        assert int(counts.max()) == kw["k_rod"]
    tiles = k8_union_tiles(tables, counts, kw["k_rod"], short_range_rd.GROUP)
    assert int(tiles.max()) > K8_STAGE_TILES
    got = short_range_rd.short_range_rd(rpos, rmass, counts, tables, **kw)
    again = short_range_rd.short_range_rd(rpos, rmass, counts, tables, **kw)
    ref = short_range_rd.short_range_rd_plain(rpos, rmass, counts, tables,
                                              **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, ref) < 1e-4
    live = torch.arange(kw["k_rod"], device=cuda_device)[None] \
        < counts[:, None]
    assert bool(torch.all(got[~live] == 0))


@pytest.mark.parametrize("scenario", ["edges", "full"])
def test_rd_plan_kernel(cuda_device, scenario):
    """K8's plan on the card lists rd_plan_plain's items, in its order of
    live rows, with the work counter at 0."""
    _, _, counts, _, kw = _rd_inputs(cuda_device, scenario)
    k_rod = kw["k_rod"]
    plan = short_range_rd.rd_plan(counts, k_rod=k_rod).cpu()
    ref = short_range_rd.rd_plan_plain(counts.cpu(), k_rod=k_rod)
    group = short_range_rd.GROUP
    n = int(plan[0])
    items = plan[2:2 + n].long()
    assert n == ref.numel() and int(plan[1]) == 0
    assert torch.equal(torch.sort(items).values, torch.sort(ref).values)
    rows = group * 16
    gpr = k_rod // rows
    c = counts.cpu().long()
    live_rows = torch.clamp(c[items // gpr] - rows * (items % gpr), 0, rows)
    assert bool(torch.all(live_rows[1:] <= live_rows[:-1]))


# -- the JAX package's random streams, oracles and engine tools -----------

def test_prng_card_equals_cpu(cuda_device):
    """utils/prng on the card: uniforms and normals bit for bit the CPU's
    draws (the normals' log1p and fused multiply-adds are correctly
    rounded float64 operations on both)."""
    from lambda_cdm_tpu_torch.utils import prng
    key = prng.PRNGKey(2026)
    for draw, shape in ((prng.uniform, (100_003, 3)),
                        (prng.normal, (64, 64, 64))):
        got = draw(key, shape, device=cuda_device)
        ref = draw(key, shape, device="cpu")
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu().view(torch.int32),
                           ref.view(torch.int32))


def test_ewald_card_equals_cpu(cuda_device):
    """The float64 Ewald and min-image oracles on the card against the
    same sums on the CPU (1e-10 relative: other summation orders)."""
    from lambda_cdm_tpu_torch.forces import ewald
    rng = np.random.default_rng(4)
    pos = torch.from_numpy(rng.uniform(0, 10.0, (3000, 3)))
    mass = torch.from_numpy(rng.uniform(0.5, 2.0, 3000))
    tgt = torch.arange(0, 3000, 97)
    for fn in (ewald.ewald_accelerations, ewald.min_image_accelerations):
        got = fn(pos.to(cuda_device), mass.to(cuda_device),
                 tgt.to(cuda_device), 10.0, softening=0.05)
        ref = fn(pos, mass, tgt, 10.0, softening=0.05)
        assert got.dtype == torch.float64 and got.device.type == "cuda"
        assert _rel(got.cpu(), ref) < 1e-10


def test_match_halos_card(cuda_device):
    """match_halos's bincount on the card equals numpy's."""
    from lambda_cdm_tpu_torch.analysis.merger_trees import match_halos
    rng = np.random.default_rng(6)
    a = rng.integers(-1, 40, 200_000)
    b = rng.integers(-1, 40, 200_000)
    got = match_halos(torch.from_numpy(a).to(cuda_device),
                      torch.from_numpy(b).to(cuda_device), max_halos=64)
    keep = (a >= 0) & (b >= 0)
    ref = np.bincount(a[keep] * 64 + b[keep], minlength=64 * 64)
    assert torch.equal(got.cpu(), torch.from_numpy(ref.reshape(64, 64))
                       .float())


def test_compiled_force_engine_card(cuda_device, tmp_path):
    """CompiledForceEngine on the card: one CUDA graph a profile, equal bit
    for bit to K4 on the padded input and to the same engine after a
    save/load round trip. The graph's output buffer is filled with NaN
    before each replay, so an equal result is the replay's; a position
    2^21 boxes out raises through K4's range flag."""
    from lambda_cdm_tpu_torch.utils.aot import CompiledForceEngine
    n, box = 3000, 50.0
    pos = tt(np.random.default_rng(8).uniform(0, box, (n, 3)))
    m = torch.ones(n)
    eng = CompiledForceEngine(box, softening=0.05, profiles=(4096, 8192),
                              device=cuda_device)
    assert eng.solver == "cuda"
    direct.reset_launch_counts()
    eng.build()
    # per profile the eager warm call and the captured call
    assert direct.launches["direct"] == 4
    pad_pos = torch.zeros(4096, 3, device=cuda_device)
    pad_pos[:n] = pos.to(cuda_device)
    pad_m = torch.zeros(4096, device=cuda_device)
    pad_m[:n] = 1.0
    ref = direct.pairwise_accelerations(pad_pos, pad_m, box, 0.05)[:n]
    eng._programs[4096].out.fill_(float("nan"))
    direct.reset_launch_counts()
    assert torch.equal(eng.compute_forces(pos, m), ref)
    assert direct.launches["direct"] == 0     # a replay calls no wrapper
    eng2 = CompiledForceEngine.load(eng.save(str(tmp_path / "e.json")),
                                    device=cuda_device)
    eng2._programs[4096].out.fill_(float("nan"))
    assert torch.equal(eng2.compute_forces(pos, m), ref)
    far = pos.clone()
    far[0, 0] = 2.0 ** 22 * box
    with pytest.raises(ValueError, match="boxes or more"):
        eng.compute_forces(far, m)


def test_engine_warmup_and_trace_on_card(cuda_device, tmp_path):
    """warmup on a card engine leaves its state as it was and the run after
    it equal to a run without it; profiling.trace_dir traces the card."""
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from lambda_cdm_tpu_torch.core.engine import SimulationEngine
    from lambda_cdm_tpu_torch.core.state import make_state
    from lambda_cdm_tpu_torch.utils.profiling import trace_summary
    pos = np.random.default_rng(0).uniform(0, 50.0, (4096, 3)).astype(
        np.float32)

    def engine(trace=""):
        cfg = SimulationConfig()
        cfg.particles.num_particles = 4096
        cfg.particles.box_size = 50.0
        cfg.forces.type = "treepm_fast"
        cfg.forces.softening_length = 0.5
        cfg.forces.rebucket_every = 2
        cfg.time.initial_timestep = 1e-5
        cfg.cosmology.initial_redshift = 9.0
        cfg.simulation.output_frequency = 4
        cfg.profiling.output_file = ""
        cfg.profiling.enabled = bool(trace)
        cfg.profiling.trace_dir = trace
        eng = SimulationEngine(cfg, device=cuda_device)
        eng.initialize(state=make_state(pos, np.zeros_like(pos),
                                        np.ones(4096, np.float32),
                                        scale_factor=0.1,
                                        device=cuda_device))
        return eng

    eng = engine(str(tmp_path / "trace"))
    before = eng._fstate.bpos.clone()
    out = eng.warmup()
    assert out["programs"] == 2 and int(eng.state.step) == 0
    assert torch.equal(eng._fstate.bpos, before)
    eng.run(num_steps=4)
    ref = engine()
    ref.run(num_steps=4)
    # K1's global adds land in a varying order: equal to float32 rounding
    assert _rel(eng.state.positions, ref.state.positions) < 1e-6
    s = trace_summary(str(tmp_path / "trace"))
    assert s["device_events"] > 0 and 0 < s["device_busy_share"] <= 1
