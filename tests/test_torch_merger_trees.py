"""Merger trees of the port (lambda_cdm_tpu_torch.analysis.merger_trees)
against the JAX package's on the same per-particle halo labels: hand-built
histories (a merger, a halo that dissolves, one that forms) and random
labels, with no FoF run (the JAX merger-tree tests, which run FoF, are in
the slow tier)."""

import dataclasses

import numpy as np
import pytest
import torch

from lambda_cdm_tpu.analysis import merger_trees as jmt
from lambda_cdm_tpu_torch.analysis import merger_trees as tmt


@dataclasses.dataclass
class Catalog:
    """The fields of HaloCatalog that the forest reads."""
    particle_label: object
    num_halos: int
    mass: object


def _labels(groups, n):
    """[n] int32 labels: halo h owns the particle ids in groups[h]."""
    lab = np.full(n, -1, np.int32)
    for h, ids in enumerate(groups):
        lab[list(ids)] = h
    return lab


def _hand_built():
    """Four snapshots of 200 particles: halos 0 and 1 merge into one,
    halo 2 grows, a halo forms late, and one dissolves."""
    n = 200
    snaps = [
        [range(0, 30), range(30, 55), range(100, 120), range(150, 162)],
        [range(0, 32), range(32, 58), range(100, 130)],
        [range(0, 60), range(100, 135), range(170, 190)],
        [range(0, 70), range(98, 140), range(168, 195)],
    ]
    return [_labels(g, n) for g in snaps]


def _random_labels(t, n, seed):
    """t snapshots of random labels with a persistent core: each particle
    keeps its halo with probability 0.8 and jumps or leaves otherwise."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(-1, 12, n).astype(np.int32)]
    for _ in range(t - 1):
        lab = out[-1].copy()
        move = rng.random(n) > 0.8
        lab[move] = rng.integers(-1, 12, int(move.sum()))
        merge = lab == 7
        lab[merge] = 3                      # halo 7 merges into 3
        out.append(lab)
    return out


def _catalogs(labels, torch_side):
    cats = []
    rng = np.random.default_rng(len(labels))
    for lab in labels:
        nh = int(lab.max()) + 1
        mass = rng.uniform(1.0, 10.0, 16).astype(np.float32)
        if torch_side:
            cats.append(Catalog(torch.from_numpy(lab), nh,
                                torch.from_numpy(mass)))
        else:
            cats.append(Catalog(lab, nh, mass))
    return cats


@pytest.mark.parametrize("max_halos", [16, 32])
def test_match_halos(max_halos):
    a, b = _random_labels(2, 5000, 3)
    ref = np.asarray(jmt.match_halos(a, b, max_halos=max_halos))
    got = tmt.match_halos(torch.from_numpy(a), torch.from_numpy(b),
                          max_halos=max_halos)
    assert got.dtype == torch.float32 and got.shape == (max_halos,) * 2
    np.testing.assert_array_equal(got.numpy(), ref)
    # every particle in a halo in both snapshots is counted once
    assert got.sum() == np.sum((a >= 0) & (b >= 0))


def test_match_halos_label_past_capacity():
    """Labels >= max_halos alias into other keys or fall past h*h, as the
    JAX package's segment sum takes them."""
    a = np.array([0, 1, 5, 5, 2, -1, 3], np.int32)
    b = np.array([0, 6, 1, 5, 7, 2, -1], np.int32)
    ref = np.asarray(jmt.match_halos(a, b, max_halos=4))
    got = tmt.match_halos(torch.from_numpy(a), torch.from_numpy(b),
                          max_halos=4)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("case", ["hand", "random"])
def test_forest_matches_jax(case):
    labels = (_hand_built() if case == "hand"
              else _random_labels(4, 3000, 11))
    a_fac = [0.25, 0.4, 0.6, 1.0]
    jf = jmt.MergerForest.build(_catalogs(labels, False), a_fac,
                                max_halos=16, min_shared=5)
    tf = tmt.MergerForest.build(_catalogs(labels, True), a_fac,
                                max_halos=16, min_shared=5)
    for lj, lt in zip(jf.links, tf.links):
        np.testing.assert_array_equal(lt.shared, lj.shared)
        for f in ("descendant", "main_progenitor", "n_progenitors"):
            np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f))
    for h in range(int(labels[-1].max()) + 1):
        assert tf.main_branch(h) == jf.main_branch(h)
        for t in range(4):
            assert tf.mergers_into(h, t) == jf.mergers_into(h, t)
    if case == "hand":
        assert tf.links[1].n_progenitors[0] == 2          # 0 and 1 merge
        assert tf.links[0].descendant[3] == -1            # halo 3 dissolves
        assert [h for _, h, _ in tf.main_branch(0)] == [0, 0, 0, 0]


def test_link_progenitors_empty():
    lab = np.full(50, -1, np.int32)
    for num_a, num_b in ((0, 0), (0, 2), (3, 0)):
        lj = jmt.link_progenitors(lab, lab, num_a=num_a, num_b=num_b,
                                  max_halos=8)
        lt = tmt.link_progenitors(torch.from_numpy(lab),
                                  torch.from_numpy(lab), num_a=num_a,
                                  num_b=num_b, max_halos=8)
        assert lt.shared.shape == lj.shared.shape == (num_a, num_b)
        np.testing.assert_array_equal(lt.descendant, lj.descendant)
        np.testing.assert_array_equal(lt.n_progenitors, lj.n_progenitors)
