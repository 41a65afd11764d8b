"""Full fp32 arithmetic on the card for fp32 configurations."""

from __future__ import annotations

import torch


def disable_tf32() -> None:
    """No TF32 anywhere: cuBLAS matmuls (off by default) and cuDNN
    convolutions (``torch.backends.cudnn.allow_tf32`` is True by default,
    which would run the perceptual loss's fp32 ``F.conv2d`` with 10
    mantissa bits). The JAX package's fp32 configurations run at
    Precision.HIGHEST."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
