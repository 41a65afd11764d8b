"""Reconstruction metrics and parameter norms on tensors (counterpart of
``vit_tpu/utils/metrics.py:13-84``).

``tree_norms`` keys each norm by the JAX package's leaf path
(``param_norm/enc/vit/transformer/layer_0/attn/qkv/kernel``), through the
bridge's name map, so the two packages' logs compare line by line. A
kernel's norm does not depend on its layout.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from vit_tpu_torch.bridge import _flax_key


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    """Peak signal-to-noise ratio per batch element; a, b: (B, H, W, C) in
    [0, max_val]."""
    mse = torch.mean((a.float() - b.float()) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Structural similarity per batch element (Wang et al. 2004: an 11 × 11
    Gaussian window of σ 1.5, K1 0.01, K2 0.03), averaged over the valid
    windows and the channels; a, b: (B, H, W, C) in [0, max_val]. The
    windowed means and (co)variances are depthwise convolutions."""
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    c = a.shape[1]
    kern = _gaussian_window(window_size, sigma, a.device)
    kern = kern.expand(c, 1, window_size, window_size)

    def blur(x):
        return F.conv2d(x, kern, groups=c)

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a * mu_a
    var_b = blur(b * b) - mu_b * mu_b
    cov = blur(a * b) - mu_a * mu_b
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den, dim=(1, 2, 3))


def global_norm(tensors) -> torch.Tensor:
    """Global L2 norm of a sequence of tensors, in fp32 (what the clip
    computes)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def tree_norms(named: Mapping[str, torch.Tensor], prefix: str) -> dict:
    """Per-tensor L2 norms of a state dict as ``{"<prefix>/<JAX leaf
    path>": 0-d fp32 tensor}``, left on the tensors' device. The sum runs
    in fp64: torch's fp32 norm of a 1M-element tensor on the CPU can be
    1e-5 off."""
    return {f"{prefix}/{_flax_key(name, t.ndim)[0]}":
            torch.linalg.vector_norm(t.detach(), dtype=torch.float64).float()
            for name, t in named.items()}
