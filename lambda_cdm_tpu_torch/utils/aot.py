"""A direct force engine captured once per capacity profile (counterpart
of lambda_cdm_tpu/utils/aot.py, the role of the reference's TensorRT
engines with their min/opt/max profiles and `.trt` files).

`CompiledForceEngine` pads every input with zero-mass rows to the next
capacity profile, so each profile's program is made once and reused for
any N up to it: on a card, one CUDA graph a profile, captured around the
solver's call on static buffers and replayed for each call (the
counterpart of the JAX package's per-profile AOT compile); on the CPU the
call itself. `save` / `load` write and read the engine's config and
profiles as JSON; `load` captures the graphs again from the kernels that
ops/cuda_build keeps in the git-ignored _build/ directory (a fresh
process with unchanged sources compiles nothing). A file saved by the
JAX package (pickled jax.export artifacts) does not load here, and a
file saved here does not load there.
"""

from __future__ import annotations

import json
import os

import torch

DEFAULT_PROFILES = (16_384, 131_072, 1_048_576)
FORMAT = "lambda_cdm_tpu_torch.CompiledForceEngine"


def _pad_to(n: int, profiles) -> int:
    for p in profiles:
        if n <= p:
            return p
    raise ValueError(f"N={n} exceeds the largest capacity profile "
                     f"{profiles[-1]} (cf. TRT max_batch_size)")


class _Program:
    """One capacity profile: static zero-padded input buffers and, on a
    card, a CUDA graph of the force call on them."""

    def __init__(self, fn, profile: int, device: torch.device):
        self.fn = fn
        self.pos = torch.zeros((profile, 3), dtype=torch.float32,
                               device=device)
        self.mass = torch.zeros((profile,), dtype=torch.float32,
                                device=device)
        self.graph = None
        if device.type != "cuda":
            return
        # one eager call on a side stream first (it builds and loads the
        # kernels), then the capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(self.pos, self.mass)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(self.pos, self.mass)

    def __call__(self, positions, masses) -> torch.Tensor:
        n = positions.shape[0]
        self.pos[:n].copy_(positions)
        self.pos[n:].zero_()
        self.mass[:n].copy_(masses)
        self.mass[n:].zero_()
        if self.graph is None:
            return self.fn(self.pos, self.mass)[:n].clone()
        self.graph.replay()
        return self.out[:n].clone()


class CompiledForceEngine:
    """Direct pairwise force engine, made once per capacity profile.

    Build once, then `compute_forces(positions, masses)` for any N up to
    the largest profile: inputs are zero-mass padded to the profile, so
    no profile is made twice."""

    def __init__(self, box_size: float, softening: float = 0.01,
                 g_const: float = 1.0, *, profiles=DEFAULT_PROFILES,
                 use_bf16: bool = False, solver: str = "auto",
                 device="cuda"):
        """solver: "cuda" (K4 through ops/direct: the kernel on a card,
        its plain version on the CPU), "reference" (the plain row-blocked
        sum of forces/direct), or "auto" ("cuda" when a card is present).
        use_bf16 rounds the positions through bfloat16 first (TensorRT's
        FP16 flag's counterpart)."""
        self.box_size = float(box_size)
        self.softening = float(softening)
        self.g_const = float(g_const)
        self.profiles = tuple(int(p) for p in profiles)
        self.use_bf16 = bool(use_bf16)
        self.device = torch.device(device)
        if solver == "auto":
            solver = "cuda" if torch.cuda.is_available() else "reference"
        if solver not in ("cuda", "reference"):
            raise ValueError(f"unknown solver {solver!r}")
        self.solver = solver
        self._programs: dict[int, _Program] = {}

    def _force(self, positions, masses):
        if self.use_bf16:
            positions = positions.to(torch.bfloat16).to(torch.float32)
        if self.solver == "cuda":
            from ..ops.direct import pairwise_accelerations
            return pairwise_accelerations(positions, masses, self.box_size,
                                          self.softening, self.g_const)
        from ..forces.direct import direct_accelerations_chunked
        return direct_accelerations_chunked(
            positions, masses, self.box_size, self.softening, self.g_const,
            chunk_size=2048)

    def _program(self, profile: int) -> _Program:
        if profile not in self._programs:
            self._programs[profile] = _Program(self._force, profile,
                                               self.device)
        return self._programs[profile]

    def build(self) -> None:
        """Make every profile's program up front."""
        for p in self.profiles:
            self._program(p)

    def compute_forces(self, positions, masses) -> torch.Tensor:
        """[N, 3] accelerations for any N <= the largest profile, on the
        engine's device."""
        pos = torch.as_tensor(positions).to(self.device, torch.float32)
        mass = torch.as_tensor(masses).to(self.device, torch.float32)
        program = self._program(_pad_to(pos.shape[0], self.profiles))
        out = program(pos, mass)
        if self.solver == "cuda":
            from ..ops.direct import check_range
            check_range()
        return out

    def config(self) -> dict:
        return {"box_size": self.box_size, "softening": self.softening,
                "g_const": self.g_const, "profiles": list(self.profiles),
                "use_bf16": self.use_bf16, "solver": self.solver}

    def save(self, path: str) -> str:
        """Make every profile, then write the engine's config and profiles
        (JSON)."""
        self.build()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"format": FORMAT, "config": self.config()}, f)
        return path

    @classmethod
    def load(cls, path: str, device="cuda") -> "CompiledForceEngine":
        """An engine from a file `save` wrote, every profile made again
        on `device`."""
        try:
            with open(path) as f:
                blob = json.load(f)
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise ValueError(f"{path} is not a {FORMAT} file (one saved by "
                             f"the JAX package does not load here)") from exc
        if not isinstance(blob, dict) or blob.get("format") != FORMAT:
            raise ValueError(f"{path} is not a {FORMAT} file")
        cfg = dict(blob["config"])
        eng = cls(cfg.pop("box_size"), profiles=cfg.pop("profiles"),
                  device=device, **cfg)
        eng.build()
        return eng
