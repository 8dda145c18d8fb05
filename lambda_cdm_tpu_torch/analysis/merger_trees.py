"""Halo merger trees by particle membership across snapshots (counterpart
of lambda_cdm_tpu/analysis/merger_trees.py).

  * `match_halos`: the shared-particle-count matrix of two catalogues, a
    bincount over joint halo-id keys on the labels' device (particle ids
    are the array order, which the simulation keeps);
  * `link_progenitors`: each early halo's descendant (largest shared
    membership, at least `min_shared`) and each late halo's main
    progenitor and progenitor count, on the host;
  * `MergerForest.build`: the links across a time-ordered sequence of
    catalogues (HaloCatalog.particle_label of find_halos, whose FoF runs
    K5 on the card), with main branches and mergers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def match_halos(plabel_a, plabel_b, *, max_halos: int = 256
                ) -> torch.Tensor:
    """Shared-particle counts [max_halos, max_halos] (float32) between the
    halos of two snapshots: shared[a, b] = particles of halo a (early)
    that are in halo b (late). plabel_a/b: [N] halo id per particle (-1
    field), one particle order in both. As in the JAX package, a particle
    outside a halo in either snapshot goes to the overflow key h*h and
    keys past it are dropped."""
    a = torch.as_tensor(plabel_a).to(torch.int64)
    b = torch.as_tensor(plabel_b).to(device=a.device, dtype=torch.int64)
    h = int(max_halos)
    in_both = (a >= 0) & (b >= 0)
    joint = torch.where(in_both, a * h + b, h * h)
    counts = torch.bincount(joint, minlength=h * h + 1)
    return counts[:h * h].reshape(h, h).to(torch.float32)


@dataclasses.dataclass
class ProgenitorLinks:
    """Links between two adjacent snapshots (host-side)."""
    descendant: np.ndarray       # [Ha] halo id in B each A-halo flows into (-1)
    main_progenitor: np.ndarray  # [Hb] largest A-progenitor of each B-halo (-1)
    n_progenitors: np.ndarray    # [Hb] number of A-halos merging into b
    shared: np.ndarray           # [Ha, Hb] particle counts


def link_progenitors(plabel_a, plabel_b, *, num_a: int, num_b: int,
                     max_halos: int = 256,
                     min_shared: int = 10) -> ProgenitorLinks:
    """Descendant/progenitor links between snapshot A (earlier) and B
    (later)."""
    shared = match_halos(plabel_a, plabel_b,
                         max_halos=max_halos).cpu().numpy()
    shared = shared[:num_a, :num_b] if num_a and num_b else \
        np.zeros((num_a, num_b))
    desc = np.full((num_a,), -1, np.int64)
    if num_a and num_b:
        best = shared.argmax(axis=1)
        ok = shared[np.arange(num_a), best] >= min_shared
        desc[ok] = best[ok]
    main_prog = np.full((num_b,), -1, np.int64)
    n_prog = np.zeros((num_b,), np.int64)
    for b in range(num_b):
        progs = np.where(desc == b)[0]
        n_prog[b] = progs.size
        if progs.size:
            main_prog[b] = progs[shared[progs, b].argmax()]
    return ProgenitorLinks(descendant=desc, main_progenitor=main_prog,
                           n_progenitors=n_prog, shared=shared)


@dataclasses.dataclass
class MergerForest:
    """Progenitor links across a full time-ordered snapshot sequence."""
    links: list            # [T-1] ProgenitorLinks (t -> t+1)
    catalogs: list         # [T] HaloCatalog
    scale_factors: list    # [T]

    @classmethod
    def build(cls, catalogs, scale_factors, *, max_halos: int = 256,
              min_shared: int = 10) -> "MergerForest":
        links = []
        for a, b in zip(catalogs[:-1], catalogs[1:]):
            links.append(link_progenitors(
                a.particle_label, b.particle_label,
                num_a=int(a.num_halos), num_b=int(b.num_halos),
                max_halos=max_halos, min_shared=min_shared))
        return cls(links=links, catalogs=list(catalogs),
                   scale_factors=list(scale_factors))

    def main_branch(self, halo_id: int) -> list[tuple[float, int, float]]:
        """Mass accretion history of a final-snapshot halo: walk main
        progenitors backwards. Returns [(a, halo_id, mass)] early->late."""
        out = []
        h = halo_id
        for t in range(len(self.catalogs) - 1, -1, -1):
            if h < 0:
                break
            mass = float(self.catalogs[t].mass[h])
            out.append((float(self.scale_factors[t]), h, mass))
            if t > 0:
                h = int(self.links[t - 1].main_progenitor[h])
        return list(reversed(out))

    def mergers_into(self, halo_id: int, t: int) -> list[int]:
        """All progenitors at snapshot t-1 that merged into `halo_id`
        at snapshot t."""
        if t == 0:
            return []
        desc = self.links[t - 1].descendant
        return [int(a) for a in np.where(desc == halo_id)[0]]
