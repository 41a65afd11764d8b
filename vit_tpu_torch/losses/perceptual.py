"""ConvNeXt-S perceptual loss (counterpart of
``vit_tpu/losses/perceptual.py:36-326``).

Both images are resized to 224 with the antialiased two-product resize,
ImageNet-normalised and run through a frozen ConvNeXt-S classifier; the loss
is the MSE between the two sets of logits. Activations are channels-last
(B, H, W, C), so every block's rows are a contiguous (B·H·W, C) view.

  - The stem and downsample convs are ``F.conv2d`` in the compute dtype,
    bias added after. The 7×7 depthwise convs are too under
    ``dw_impl="lax"`` (the default; XLA convs on the TPU), or K11a/K11b
    (``kernels/depthwise.py``) under ``dw_impl="pallas"``, as
    ``DWConv7`` routes them (:55-67).
  - Blocks with C ≤ 384 run the fused tail LN → pwconv1 → GELU → pwconv2 →
    γ → residual through K3/K4 (``kernels/convnext_block.py``), as the TPU
    runs them; the stage-3 blocks (C 768) run it unfused (``fused_supported``,
    ``vit_tpu/kernels/convnext_block.py:453``).
  - ``quant="int8"`` (``--perceptual_quant int8``) runs the frozen net's
    pointwise products int8 × int8 → int32: the fused tails through
    K12a/K12b, the unfused stage 3 through ``core/quant.py``'s
    ``frozen_int8_dense`` (:158-189). The default is ``quant="none"``.
  - LayerNorm is affine with eps 1e-6 and rounds where flax's ``nn.LayerNorm``
    rounds at a half ``dtype``: fp32 statistics (E[x²] − E[x]²), fp32
    normalise-scale-shift, one cast to the compute dtype.
  - The net is frozen: no parameter requires grad, and the target image's
    branch runs under ``torch.no_grad()``.

Weights: the JAX package's ``.npz`` layout (``load_params``) carried over by
``vit_tpu_torch.bridge``, or the flax initialisers from a generator
(``utils/init.py:init_convnext_``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.quant import frozen_int8_dense
from vit_tpu_torch.core.transformer import linear
from vit_tpu_torch.kernels.convnext_block import (QUANTS,
                                                  frozen_convnext_block_tail,
                                                  fused_supported)
from vit_tpu_torch.kernels.depthwise import depthwise_conv
from vit_tpu_torch.losses.resize import resize_bilinear_antialias
from vit_tpu_torch.ops.gelu import gelu

DW_IMPLS = ("lax", "pallas")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# ConvNeXt-Small (torchvision convnext_small): depths / widths
CONVNEXT_S_DEPTHS = (3, 3, 27, 3)
CONVNEXT_S_DIMS = (96, 192, 384, 768)


class LayerNorm(nn.Module):
    """Affine LayerNorm over the last axis with flax ``nn.LayerNorm``'s
    rounding (statistics in fp32 as E[x²] − mean², eps 1e-6, the affine in
    fp32); the output is in ``dtype``. The enhancing ViT-VQGAN's norms are
    these too."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((x32 - mu) * mul + self.bias.float()).to(self.dtype)


class Conv(nn.Module):
    """A conv on channels-last activations with nn.Conv's param tree:
    ``weight`` (O, I/groups, k, k) and ``bias`` (O,), run in ``dtype``."""

    def __init__(self, din: int, dout: int, k: int, dtype: torch.dtype, *,
                 stride: int = 1, padding: int = 0, groups: int = 1):
        super().__init__()
        self.dtype, self.stride, self.padding, self.groups = (
            dtype, stride, padding, groups)
        self.weight = nn.Parameter(torch.empty(dout, din // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                       self.weight.to(self.dtype), None, self.stride,
                       self.padding, 1, self.groups).permute(0, 2, 3, 1)
        return out + self.bias.to(out.dtype)


class ConvNeXtBlock(nn.Module):
    """7×7 depthwise conv → LN → 4× MLP with GELU → layer scale, residual.
    Everything after the depthwise conv runs as the fused tail (K3/K4, or
    K12a/K12b under ``quant="int8"``) where ``fused_supported(C, 4C)``, as
    separate ops elsewhere. ``dw_impl="pallas"`` runs the depthwise conv
    through K11a/K11b."""

    def __init__(self, dim: int, dtype: torch.dtype, dw_impl: str = "lax",
                 quant: str = "none"):
        super().__init__()
        if dw_impl not in DW_IMPLS or quant not in QUANTS:
            raise ValueError(f"dw_impl must be one of {DW_IMPLS} and quant "
                             f"one of {QUANTS}, got {dw_impl!r}, {quant!r}")
        self.dtype, self.dw_impl, self.quant = dtype, dw_impl, quant
        self.dwconv = Conv(dim, dim, 7, dtype, padding=3, groups=dim)
        self.norm = LayerNorm(dim, dtype)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def _depthwise(self, x: torch.Tensor) -> torch.Tensor:
        if self.dw_impl == "lax":
            return self.dwconv(x)
        taps = self.dwconv.weight[:, 0].permute(1, 2, 0)   # (7, 7, C)
        return depthwise_conv(x.to(self.dtype).contiguous(),
                              taps.to(self.dtype),
                              self.dwconv.bias.to(self.dtype), 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._depthwise(x)
        shape, c = h.shape, h.shape[-1]
        if fused_supported(c, 4 * c):
            y = frozen_convnext_block_tail(
                h.reshape(-1, c), x.to(h.dtype).reshape(-1, c),
                self.norm.weight, self.norm.bias, self.pwconv1.weight,
                self.pwconv1.bias, self.pwconv2.weight, self.pwconv2.bias,
                self.gamma, eps=self.norm.eps, quant=self.quant)
            return y.reshape(shape)
        h = self.norm(h.reshape(-1, c))
        if self.quant == "int8":
            # LN in the compute dtype; the second product's input is rounded
            # to it before it is quantized (the fused K12a does not round)
            h = frozen_int8_dense(h, self.pwconv1.weight.t(),
                                  self.pwconv1.bias)
            h = gelu(h.to(self.dtype))
            h = frozen_int8_dense(h, self.pwconv2.weight.t(),
                                  self.pwconv2.bias).to(self.dtype)
        else:
            h = linear(gelu(linear(h, self.pwconv1, self.dtype)),
                       self.pwconv2, self.dtype)
        return x + self.gamma.to(h.dtype) * h.reshape(shape)


class ConvNeXt(nn.Module):
    """ConvNeXt classifier on NHWC images; defaults are ConvNeXt-Small.
    Module names are the flax tree's (``stem_conv``, ``stage2_block5``, ...),
    so the bridge maps one onto the other leaf by leaf, whatever ``dw_impl``
    and ``quant`` (they change the arithmetic, not the parameters)."""

    def __init__(self, depths: Sequence[int] = CONVNEXT_S_DEPTHS,
                 dims: Sequence[int] = CONVNEXT_S_DIMS,
                 num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 dw_impl: str = "lax", quant: str = "none"):
        super().__init__()
        self.depths, self.dims, self.dtype = tuple(depths), tuple(dims), dtype
        self.stem_conv = Conv(3, dims[0], 4, dtype, stride=4)   # RGB in
        self.stem_norm = LayerNorm(dims[0], dtype)
        for stage, (depth, dim) in enumerate(zip(depths, dims)):
            if stage > 0:
                setattr(self, f"downsample_norm_{stage}",
                        LayerNorm(dims[stage - 1], dtype))
                setattr(self, f"downsample_conv_{stage}",
                        Conv(dims[stage - 1], dim, 2, dtype, stride=2))
            for block in range(depth):
                setattr(self, f"stage{stage}_block{block}",
                        ConvNeXtBlock(dim, dtype, dw_impl, quant))
        self.head_norm = LayerNorm(dims[-1], torch.float32)
        self.head = nn.Linear(dims[-1], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_norm(self.stem_conv(x))
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                x = getattr(self, f"downsample_norm_{stage}")(x)
                x = getattr(self, f"downsample_conv_{stage}")(x)
            for block in range(depth):
                x = getattr(self, f"stage{stage}_block{block}")(x)
        x = x.float().mean((1, 2)).to(x.dtype)   # global average pool
        return linear(self.head_norm(x), self.head, torch.float32)


class PerceptualLoss(nn.Module):
    """Frozen ConvNeXt logit-matching loss: MSE between the logits of the
    two resized, ImageNet-normalised images."""

    image_size = 224   # the classifier's training resolution

    def __init__(self, net: ConvNeXt):
        super().__init__()
        self.net = net.eval().requires_grad_(False)

    @staticmethod
    def load_params(path: str) -> dict:
        """The JAX package's ``.npz`` of "a/b/c" → array entries
        (``scripts/convert_perceptual_weights.py``), as a nested dict."""
        from vit_tpu_torch.bridge import unflatten

        with np.load(path) as npz:
            return unflatten({k: npz[k] for k in npz.files})

    @classmethod
    def from_params(cls, params: dict, *, dtype: torch.dtype = torch.float32,
                    **convnext_kw) -> "PerceptualLoss":
        """A PerceptualLoss whose ConvNeXt holds the flax-layout ``params``;
        ``convnext_kw`` go to :class:`ConvNeXt` (``dw_impl``, ``quant``,
        depths and widths)."""
        from vit_tpu_torch.bridge import convnext_state_dict_from_flax

        net = ConvNeXt(dtype=dtype, **convnext_kw)
        net.load_state_dict(convnext_state_dict_from_flax(params, net))
        return cls(net)

    def _prep(self, img: torch.Tensor) -> torch.Tensor:
        dt = self.net.dtype
        img = resize_bilinear_antialias(img.to(dt), self.image_size,
                                        self.image_size)
        mean = torch.tensor(IMAGENET_MEAN, dtype=dt, device=img.device)
        std = torch.tensor(IMAGENET_STD, dtype=dt, device=img.device)
        return (img - mean) / std

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (B, H, W, 3) in [0, 1] → scalar MSE between logits; the
        gradient flows to x only."""
        logits_x = self.net(self._prep(x))
        with torch.no_grad():
            logits_y = self.net(self._prep(y))
        return torch.mean((logits_x - logits_y) ** 2)
