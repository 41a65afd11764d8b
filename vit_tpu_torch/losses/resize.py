"""Bilinear+antialias image resize as two matrix products (counterpart of
``vit_tpu/losses/resize.py:19-54``).

out = A · img · Bᵀ with static triangle-filter matrices built exactly as the
JAX package builds them (Pillow/torch antialias construction: support scaled
by the downscale ratio, normalised per output pixel), applied as two einsums
in the input dtype.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=32)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) triangle-filter resampling matrix (antialiased)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    mat = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(np.floor(center - support)), 0)
        hi = min(int(np.ceil(center + support)), in_size)
        x = np.arange(lo, hi) + 0.5
        w = np.maximum(0.0, 1.0 - np.abs((x - center) / filterscale))
        total = w.sum()
        if total > 0:
            mat[i, lo:hi] = w / total
    return mat


def resize_bilinear_antialias(img: torch.Tensor, out_h: int,
                              out_w: int) -> torch.Tensor:
    """img (B, H, W, C) → (B, out_h, out_w, C) in the input dtype (fp32 or
    bf16; anything else computes in fp32)."""
    _, h, w, _ = img.shape
    dt = img.dtype if img.dtype in (torch.float32, torch.bfloat16) \
        else torch.float32
    a = torch.from_numpy(_resize_matrix(h, out_h)).to(img.device, dt)
    bmat = torch.from_numpy(_resize_matrix(w, out_w)).to(img.device, dt)
    x = torch.einsum("oh,bhwc->bowc", a, img.to(dt))       # rows
    return torch.einsum("ow,bhwc->bhoc", bmat, x)           # columns
