"""U-ViT building blocks (counterpart of ``vit_tpu/core/uvit.py``):
``DropPath`` stochastic depth, the standalone ``Mlp`` and ``UViTBlock``, a
pre-LN block with an optional skip concatenation merged by a dense layer and
optional recomputation in the backward (``use_checkpoint``, through
``core/transformer.py:checkpointed``, the whole block).

Activations are (B, S, dim), channels last. The LayerNorms are affine, fp32,
eps 1e-5; the dense layers compute in ``dtype``. The block's attention runs
``ops/attention.py:fused_qkv_attention`` on the unbiased qkv product with
the qkv bias (zeros without ``qkv_bias``) added inside the kernels, so K1/K2
run where the shape is packed-supported. Dropout and stochastic depth run
while the module is training, from an explicit ``torch.Generator``: the
masks cannot be the JAX package's ``jax.random`` draws.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.transformer import checkpointed, linear
from vit_tpu_torch.ops.attention import fused_qkv_attention
from vit_tpu_torch.ops.gelu import gelu as gelu_op


def _keep(shape, rate: float, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Kept values divided by 1 − rate, the rest 0 (``nn.Dropout``)."""
    if rate == 0.0:
        return x
    return torch.where(_keep(x.shape, rate, generator, x.device),
                       x / (1.0 - rate), 0.0)


class DropPath(nn.Module):
    """Per-sample stochastic depth: with probability ``rate`` a sample's
    whole branch is dropped; survivors are scaled by 1 / (1 − rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: "torch.Generator | None" = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return torch.where(_keep(shape, self.rate, generator, x.device),
                           x / (1.0 - self.rate), 0.0)


class Mlp(nn.Module):
    """fc1 → GELU → dropout → fc2 → dropout, both products in ``dtype``."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        kw = dict(dtype=param_dtype, device=device)
        self.fc1 = nn.Linear(in_features, hidden_features, **kw)
        self.fc2 = nn.Linear(hidden_features, out_features, **kw)

    def forward(self, x: torch.Tensor,
                generator: "torch.Generator | None" = None) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        h = dropout(gelu_op(linear(x, self.fc1, self.dtype)), rate, generator)
        return dropout(linear(h, self.fc2, self.dtype), rate, generator)


class UViTBlock(nn.Module):
    """Pre-LN attention and MLP block with an optional skip merge
    (``skip_linear`` over [x, skip]) and recomputation
    (``use_checkpoint``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, dropout: float = 0.0,
                 drop_path: float = 0.0, skip: bool = False,
                 use_checkpoint: bool = False,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.use_checkpoint = use_checkpoint
        kw = dict(dtype=param_dtype, device=device)
        self.skip_linear = nn.Linear(2 * dim, dim, **kw) if skip else None
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, **kw)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dropout, dtype,
                       param_dtype, device)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                generator: "torch.Generator | None" = None) -> torch.Tensor:
        if self.skip_linear is not None:
            if skip is None:
                raise ValueError("skip=True requires a skip tensor")
            x = linear(torch.cat([x, skip], dim=-1), self.skip_linear,
                       self.dtype)
        if self.use_checkpoint:
            return checkpointed(self._body, x, generator)
        return self._body(x, generator)

    def _body(self, x: torch.Tensor, generator) -> torch.Tensor:
        dt = self.dtype
        h = F.layer_norm(x.float(), self.norm1.normalized_shape,
                         self.norm1.weight.float(), self.norm1.bias.float(),
                         1e-5)
        qkv = F.linear(h.to(dt), self.qkv.weight.to(dt))
        attn = fused_qkv_attention(qkv, self.num_heads,
                                   qkv_bias=self.qkv.bias)
        x = x + self.drop_path1(linear(attn, self.proj, dt), generator)
        h = F.layer_norm(x.float(), self.norm2.normalized_shape,
                         self.norm2.weight.float(), self.norm2.bias.float(),
                         1e-5)
        return x + self.drop_path2(self.mlp(h.to(dt), generator), generator)
