"""The port's float32 rule: TF32 off on the card."""

from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Keep float32 matrix products and convolutions in full float32 (the
    JAX package passes Precision.HIGHEST where XLA would truncate): turn
    off torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32. The entry points (cli.main,
    science_run.main) call it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
