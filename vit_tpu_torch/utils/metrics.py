"""Reconstruction metrics, parameter norms and histograms on tensors
(counterpart of ``vit_tpu/utils/metrics.py:13-100``).

``tree_norms`` and ``tree_histograms`` key each tensor by the JAX package's
leaf path (``param_norm/enc/vit/transformer/layer_0/attn/qkv/kernel``),
through the bridge's name map, so the two packages' logs compare line by
line. Neither depends on a kernel's layout.
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


def histogram(x: torch.Tensor, bins: int = 64
              ) -> "tuple[torch.Tensor, torch.Tensor]":
    """``jnp.histogram(x, bins)`` on the tensor's device: (counts fp32
    (bins,), edges fp32 (bins + 1,)). The edges span [min, max] (± 0.5 when
    they are equal) as JAX's fp32 ``linspace``, lo·(1 − t) + hi·t with t =
    i / bins, the second product fused into the sum as XLA evaluates it; a
    value's bin is ``searchsorted(edges, x, side="right")``, the last bin
    closed on the right. (``torch.histc`` puts a value on an inner edge
    elsewhere.) No host sync."""
    x = x.detach().float().reshape(-1)
    lo, hi = x.min(), x.max()
    flat = hi == lo
    lo = torch.where(flat, lo - 0.5, lo)
    hi = torch.where(flat, hi + 0.5, hi)
    t = torch.arange(bins, dtype=torch.float32, device=x.device) / bins
    inner = (hi.double() * t.double() + (lo * (1 - t)).double()).float()
    edges = torch.cat([inner, hi[None]])
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    counts = torch.zeros(bins + 1, dtype=torch.float32, device=x.device)
    counts.index_add_(0, idx, torch.ones_like(x))
    return counts[1:], edges


def tree_histograms(named: Mapping[str, torch.Tensor], prefix: str,
                    bins: int = 64) -> dict:
    """Per-tensor value histograms of a state dict as ``{"<prefix>/<JAX
    leaf path>": (counts, edges)}``, left on the tensors' device (the
    ``--watch`` surface, ``vit_tpu/utils/metrics.py:85-100``)."""
    return {f"{prefix}/{_flax_key(name, t.ndim)[0]}": histogram(t, bins)
            for name, t in named.items()}
