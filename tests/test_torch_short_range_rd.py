"""K8 (the rod-dense short-range pair sum) of the PyTorch port against the
JAX package: the packing (rd_pack) and the window tables
(rd_window_tables) exactly equal, the plain K8 against the TPU kernel in
Pallas interpret mode, against the exact-erfc dense oracle and against
K3's vpu3 plain version on the cell buckets of the same particles -- in
the uniform, blob and edges scenarios of tests/test_short_range_rd.py, at
a size where each rod holds one or two 16-row chunks."""

import numpy as np
import pytest
import torch

from _torch_parity import max_rel, nn, tt

import jax.numpy as jnp

from lambda_cdm_tpu.forces.direct import min_image
from lambda_cdm_tpu.forces.treepm import short_range_factor
from lambda_cdm_tpu.ops import pallas_short_range_rd as jrd
import lambda_cdm_tpu_torch.ops.fast_treepm as tft
from lambda_cdm_tpu_torch.ops.bucketed_pm import live_counts
from lambda_cdm_tpu_torch.ops import short_range as tsr
from lambda_cdm_tpu_torch.ops import short_range_rd as trd

BOX, NCELL = 64.0, 4
RS, SOFT = 2.0, 0.1          # r_cut = 4.5 rs = 9 <= cell = 16
R_CUT = 4.5 * RS
N, N_DEAD = 384, 16
SCENARIOS = ("uniform", "blob", "edges")
# the JAX package's bar for K3 and K8 against the exact-erfc oracle
ERFC_TOL = 1e-3


def _particles(scenario, seed=2):
    """The JAX test's scenarios, drawn with numpy: uniform; a quarter of
    the particles in a Gaussian blob at the centre; half of them in thin z
    slabs at both box faces (every rod exercises the wrap segments). The
    last N_DEAD rows have mass 0."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, BOX, (N, 3))
    if scenario == "blob":
        nb = N // 4
        pos[:nb] = BOX / 2 + 1.5 * rng.standard_normal((nb, 3))
    if scenario == "edges":
        nb = N // 2
        dz = rng.uniform(0.0, 0.05 * BOX, nb)
        pos[:nb, 2] = np.where(np.arange(nb) % 2 == 0, dz, BOX - dz)
    pos = np.mod(pos, BOX).astype(np.float32)
    m = rng.uniform(0.5, 2.0, N).astype(np.float32)
    m[-N_DEAD:] = 0.0
    return pos, m


def _packs(scenario):
    pos, m = _particles(scenario)
    k_rod = trd.rd_geometry(N, NCELL)
    jp = jrd.rd_pack(jnp.asarray(pos), jnp.asarray(m), BOX, ncell=NCELL,
                     k_rod=k_rod)
    tp = trd.rd_pack(tt(pos), tt(m), BOX, ncell=NCELL, k_rod=k_rod)
    return pos, m, k_rod, jp, tp


def _tables(pack, k_rod, mod):
    return mod.rd_window_tables(pack[3], pack[2], ncell=NCELL, k_rod=k_rod,
                                box_size=BOX, window=R_CUT)


def _per_particle(acc_slots, src):
    """[R, K_rod, 3] slot accelerations -> [N, 3] by particle (0 for a row
    that has no slot)."""
    flat = nn(acc_slots).reshape(-1, 3)
    src = nn(src)
    out = np.zeros((N + 1, 3))
    out[np.where(src < N, src, N)] = flat
    return out[:N]


def _dense_oracle(pos, m):
    """All-pairs exact-erfc short-range accelerations (the JAX test's
    oracle)."""
    p = jnp.asarray(pos)
    d = min_image(p[None, :, :] - p[:, None, :], BOX)
    r2 = jnp.sum(d * d, axis=-1) + SOFT * SOFT
    r = jnp.sqrt(r2)
    w = jnp.asarray(m)[None, :] * short_range_factor(r, RS) / (r2 * r)
    w = w * (1.0 - jnp.eye(N))
    return np.asarray(jnp.sum(w[..., None] * d, axis=1))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_pack_and_tables_exact(scenario):
    pos, m, k_rod, jp, tp = _packs(scenario)
    for name, r, g in zip(("rpos", "rmass", "counts", "rzq", "overflow",
                           "src"), jp, tp):
        np.testing.assert_array_equal(nn(g), np.asarray(r), err_msg=name)
    assert int(tp[4]) == 0 and int(nn(tp[2]).sum()) == N - N_DEAD
    jt, tt_ = _tables(jp, k_rod, jrd), _tables(tp, k_rod, trd)
    assert tt_.dtype == torch.int32
    np.testing.assert_array_equal(nn(tt_), np.asarray(jt))
    if scenario == "edges":      # the wrap segments are in use
        zsel, nt, _ = trd._decode(tt_)
        assert bool(torch.any((zsel > 0) & (nt > 0)))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_plain_matches_interpret(scenario):
    """Live slots at 1e-5 of the max (one interpret-mode compile: about
    9 s on one core); dead slots exactly 0."""
    pos, m, k_rod, jp, tp = _packs(scenario)
    geo = dict(ncell=NCELL, k_rod=k_rod, box_size=BOX, rs=RS,
               softening=SOFT)
    ref = jrd.pallas_short_range_rd(jp[0], jp[1], jp[2],
                                    _tables(jp, k_rod, jrd),
                                    interpret=True, **geo)
    got = trd.short_range_rd(tp[0], tp[1], tp[2], _tables(tp, k_rod, trd),
                             **geo)
    live = np.arange(k_rod)[None] < nn(tp[2])[:, None]
    assert max_rel(got, ref, live[..., None]) < 1e-5
    assert np.all(nn(got)[~live] == 0.0)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_plain_matches_oracle_and_vpu3(scenario):
    """Against the exact-erfc dense oracle at ERFC_TOL, and against K3's
    vpu3 on the cell buckets of the same particles at 2 ERFC_TOL: each
    holds the oracle's bar, and they take different pairs between r_cut
    and the split polynomial's end (6 rs)."""
    pos, m, k_rod, _, tp = _packs(scenario)
    got = _per_particle(trd.short_range_rd(
        tp[0], tp[1], tp[2], _tables(tp, k_rod, trd), ncell=NCELL,
        k_rod=k_rod, box_size=BOX, rs=RS, softening=SOFT), tp[5])
    live = (m > 0)[:, None]
    assert max_rel(got, _dense_oracle(pos, m), live) < ERFC_TOL

    cap = 128
    plan = {"ncell": NCELL, "capacity": cap, "margin": 1, "rs": RS}
    fs = tft.build_fast_state(tt(pos), torch.zeros(N, 3), tt(m), 1.0,
                              box_size=BOX, plan=plan)
    assert int(fs.overflow) == 0
    k3 = tsr.short_range_plain(fs.bpos, fs.bmass, live_counts(fs.bmass),
                               ncell=NCELL, capacity=cap, box_size=BOX,
                               rs=RS, softening=SOFT, variant="vpu3")
    ids = nn(fs.ids).reshape(-1)
    k3p = np.zeros((N, 3))
    k3p[ids[ids >= 0]] = nn(k3).reshape(3, -1).T[ids >= 0]
    assert max_rel(got, k3p, live) < 2 * ERFC_TOL


def test_rows_form_and_validation():
    pos, m, k_rod, _, tp = _packs("blob")
    tables = _tables(tp, k_rod, trd)
    geo = dict(ncell=NCELL, k_rod=k_rod, box_size=BOX, rs=RS,
               softening=SOFT)
    full = nn(trd.short_range_rd_plain(tp[0], tp[1], tp[2], tables, **geo))
    rows = np.random.default_rng(3).choice(NCELL ** 2 * k_rod, 300,
                                           replace=False)
    got = nn(trd.short_range_rd_plain(tp[0], tp[1], tp[2], tables,
                                      rows=tt(rows, None), **geo))
    assert got.shape == (300, 3)
    assert max_rel(got, full.reshape(-1, 3)[rows]) < 1e-6
    with pytest.raises(ValueError, match="1024"):
        trd.short_range_rd(tp[0], tp[1], tp[2], tables,
                           **dict(geo, k_rod=k_rod + 128))
    with pytest.raises(ValueError, match="softening"):
        trd.short_range_rd(tp[0], tp[1], tp[2], tables,
                           **dict(geo, softening=0.0))
    assert trd.rd_geometry(1_000_000, 24) == jrd.rd_geometry(1_000_000, 24) \
        == 3072
    assert trd._zbits(24) == jrd._zbits(24)
