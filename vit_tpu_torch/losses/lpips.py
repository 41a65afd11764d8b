"""LPIPS perceptual metric: AlexNet trunk and linear calibration heads
(counterpart of ``vit_tpu/losses/lpips.py``).

    d(x, y) = sum_l  mean_hw  || w_l ⊙ ( ê_l(x) − ê_l(y) ) ||²

ê_l are the channel-unit-normalised activations at AlexNet's five ReLU taps
and w_l the nonnegative 1×1 heads ``lin{l}`` of shape (C,), no bias. Images
come in NHWC in [0, 1], go to [-1, 1] and through LPIPS's fixed shift and
scale. The convolutions are plain ``F.conv2d`` (NCHW inside), as the JAX
package leaves them to XLA outside any Pallas kernel; a VALID 3×3 / 2 max
pool follows the first two taps.

Weights are a param tree in the JAX layout (``alex/conv{i}/{kernel,bias}``
with HWIO kernels, ``lin{i}``), carried into the module by
``vit_tpu_torch.bridge``: ``load_params`` reads the flattened "a/b/c"
``.npz`` that ``scripts/convert_lpips_weights.py`` writes; ``init_params``
draws an architecture-only tree. Pretrained weights are not in the repo.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# LPIPS's ScalingLayer constants (inputs in [-1, 1]) and normalize_tensor eps
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
LPIPS_NORM_EPS = 1e-10

# torchvision AlexNet features: (out_ch, ksize, stride, padding), ReLU after
# each conv; MaxPool(3, 2) after relu1 and relu2 (the pool after relu5 lies
# below the deepest tap and is left out)
ALEXNET_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)  # a max pool follows these conv indices

# stddev of a standard normal truncated to (-2, 2), as flax's lecun_normal
_TRUNC_STD = 0.87962566103423978


def unit_normalize(f: torch.Tensor, eps: float = LPIPS_NORM_EPS,
                   dim: int = -1) -> torch.Tensor:
    """``f / (sqrt(sum_c f²) + eps)``: eps added to the norm, not to the sum
    of squares, as LPIPS's ``normalize_tensor``."""
    norm = torch.sqrt(torch.sum(f * f, dim=dim, keepdim=True))
    return f / (norm + eps)


class AlexNetFeatures(nn.Module):
    """Five-tap AlexNet trunk: NHWC images → [relu1..relu5], each NHWC."""

    def __init__(self, convs=ALEXNET_CONVS, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.convs = tuple(convs)
        self.dtype = dtype
        cin = 3
        for i, (ch, k, _, _) in enumerate(self.convs):
            setattr(self, f"conv{i}", nn.Conv2d(cin, ch, k, device=device))
            cin = ch

    def forward(self, x: torch.Tensor) -> "list[torch.Tensor]":
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        taps = []
        for i, (_, _, s, p) in enumerate(self.convs):
            conv = getattr(self, f"conv{i}")
            x = F.relu(F.conv2d(x, conv.weight.to(self.dtype),
                                conv.bias.to(self.dtype), stride=s,
                                padding=p))
            taps.append(x.permute(0, 2, 3, 1))
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return taps


class LPIPS(nn.Module):
    """LPIPS distance: ``forward(x, y)`` with NHWC images in [0, 1] → (B,)
    distances, in ``dtype``."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.alex = AlexNetFeatures(dtype=dtype, device=device)
        for i, (ch, _, _, _) in enumerate(ALEXNET_CONVS):
            self.register_parameter(f"lin{i}", nn.Parameter(
                torch.ones(ch, device=device)))

    def _prep(self, img: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(LPIPS_SHIFT, dtype=self.dtype, device=img.device)
        scale = torch.tensor(LPIPS_SCALE, dtype=self.dtype, device=img.device)
        img = img.to(self.dtype) * 2.0 - 1.0   # [0, 1] → [-1, 1]
        return (img - shift) / scale

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        feats_x = self.alex(self._prep(x))
        feats_y = self.alex(self._prep(y))
        total = 0.0
        for i, (fx, fy) in enumerate(zip(feats_x, feats_y)):
            diff2 = (unit_normalize(fx) - unit_normalize(fy)) ** 2
            w = getattr(self, f"lin{i}").to(diff2.dtype)
            total = total + torch.mean(torch.sum(diff2 * w, dim=-1),
                                       dim=(1, 2))
        return total


@torch.no_grad()
def init_params(seed: int = 0) -> dict:
    """An architecture-correct random tree in the JAX layout: lecun-normal
    conv kernels (a normal truncated at ±2σ, rescaled to variance 1/fan_in),
    zero biases and unit heads, as the flax initialisers, but drawn from a
    ``torch.Generator`` seeded ``seed`` (JAX's draws cannot be reproduced
    here). For smoke and speed runs only: NOT comparable to published LPIPS
    numbers."""
    from vit_tpu_torch.bridge import flax_tree
    from vit_tpu_torch.utils.init import standard_trunc_normal_

    gen = torch.Generator().manual_seed(seed)
    net = LPIPS()
    for i in range(len(ALEXNET_CONVS)):
        conv = getattr(net.alex, f"conv{i}")
        w = conv.weight
        std = math.sqrt(1.0 / math.prod(w.shape[1:])) / _TRUNC_STD
        standard_trunc_normal_(w, gen).mul_(std)
        conv.bias.zero_()
    return flax_tree(net.state_dict())


def load_params(path: str) -> dict:
    """The flattened 'a/b/c' → array ``.npz`` of
    ``scripts/convert_lpips_weights.py`` as a nested dict (the JAX tree)."""
    from vit_tpu_torch.bridge import unflatten

    with np.load(path) as npz:
        return unflatten({k: npz[k] for k in npz.files})


def build(params: dict, *, dtype: torch.dtype = torch.float32,
          device="cuda") -> LPIPS:
    """An ``LPIPS`` on ``device`` holding the JAX-layout ``params``, frozen."""
    from vit_tpu_torch.bridge import lpips_state_dict_from_flax

    net = LPIPS(dtype=dtype, device="meta")
    net.load_state_dict(lpips_state_dict_from_flax(params), assign=True)
    return net.to(device).eval().requires_grad_(False)


def lpips_fn(params: dict, *, dtype: torch.dtype = torch.float32,
             device="cuda"):
    """(x, y) → (B,) LPIPS distances, a closure over ``params`` loaded on
    ``device``."""
    net = build(params, dtype=dtype, device=device)

    @torch.inference_mode()
    def fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return net(x, y)

    return fn
