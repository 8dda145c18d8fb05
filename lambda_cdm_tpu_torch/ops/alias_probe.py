"""K10: the aliased in-place row probe -- the CUDA kernel
csrc/alias_probe.cu with its plain PyTorch version (counterpart of the
TPU kernel `kern` in benchmarks/probe_alias.py).

On a [rows, cols] float32 buffer, in place, step i writes row max(i - 1,
0) + 1 to row i. "sequential" takes the steps in order (Gauss-Seidel:
1, 2, ..., rows in column 0 from zeros); "blocks" (the kernel's other
mode) launches one block a row, whose order CUDA leaves undefined; the
plain version of that mode is the snapshot (every step reads the buffer
as it was: all ones from zeros). CUDA tensors launch K10, CPU tensors
take the plain version.

    python -m lambda_cdm_tpu_torch.ops.alias_probe [--device cpu]

prints column 0 of an [8, 128] zero buffer after each mode.
"""

from __future__ import annotations

import argparse

import torch

from . import cuda_build

MODES = ("blocks", "sequential")
ROWS, COLS = 8, 128          # the TPU probe's buffer

launches = {"alias_probe": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def alias_probe_plain(x, sequential: bool):
    """In place: x[i] = x[max(i - 1, 0)] + 1 for i = 0..rows-1, reading
    the updated buffer (sequential) or a snapshot of it. Returns x."""
    src = x.clone() if not sequential else x
    for i in range(x.shape[0]):
        x[i] = src[max(i - 1, 0)] + 1.0
    return x


def alias_probe(x, mode: str = "sequential"):
    """Run the probe in place on a [rows, cols] float32 tensor in `mode`
    ("blocks" or "sequential") and return it: K10 on a CUDA tensor, the
    plain version on a CPU tensor (the snapshot for "blocks")."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be a 2-D float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    sequential = mode == "sequential"
    if x.device.type == "cpu":
        return alias_probe_plain(x, sequential)
    cuda_build.require_cuda("alias_probe", x)
    launches["alias_probe"] += 1
    cuda_build.launch("lcdm_alias_probe", x.data_ptr(), x.shape[0],
                      x.shape[1], int(sequential))
    return x


def launch_floor(blocks: int, threads: int, x=None) -> None:
    """Launch the floor kernel of csrc/alias_probe.cu on the current
    stream at a launch shape (not K10, so not counted): empty, or with `x`
    (a CUDA float32 tensor of at least blocks * threads elements) adding 1
    to one element a thread, one read and one dependent write."""
    if x is not None:
        cuda_build.require_cuda("launch_floor", x, dtypes=(torch.float32,))
        if x.numel() < blocks * threads:
            raise ValueError(f"launch_floor: x holds {x.numel()} floats, "
                             f"fewer than {blocks} x {threads}")
    cuda_build.launch("lcdm_launch_floor", 0 if x is None else x.data_ptr(),
                      int(blocks), int(threads))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    for mode in MODES:
        x = alias_probe(torch.zeros((ROWS, COLS), device=device), mode)
        print(f"{device.type} {mode}: {x[:, 0].cpu().numpy()}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
