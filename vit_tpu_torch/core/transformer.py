"""Shared pre-LN transformer core (counterpart of
``vit_tpu/core/transformer.py:105-437``).

Blocks of [LayerNorm → fused-QKV attention] and [LayerNorm → 4× GELU MLP],
with residual adds around both, in the compute dtype. Parameters stay fp32
and every matmul casts its operands to ``cfg.dtype`` explicitly. The QKV
projection is applied without its bias, which the attention kernel adds as it
reads each tile (``kernels/attention.py``).

Ported so far: the unrolled stack's forward with the non-affine LayerNorm and
no attention output projection (the author's minimal block). Not yet: the
Bytedance layout (``ln_affine``, ``attn_out_proj``), dropout, remat,
KV-cache decode, the scanned and pipelined stacks, int8, and the fused-LN
and fused-FC kernel paths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.config import TransformerConfig
from vit_tpu_torch.ops.attention import fused_qkv_attention
from vit_tpu_torch.ops.gelu import gelu as gelu_op


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.ln_affine or cfg.attn_out_proj:
        raise NotImplementedError(
            "the Bytedance block layout (ln_affine, attn_out_proj) is not "
            "ported yet")
    if cfg.dropout > 0.0:
        raise NotImplementedError("dropout is a training feature, not ported "
                                  "yet")


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    """``layer`` applied in ``dtype``: input, weight and bias cast first."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class LayerNorm(nn.Module):
    """Non-affine LayerNorm: fp32 statistics, eps 1e-5, output in the compute
    dtype."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + 1e-5)
        return y.to(self.config.dtype)


class Attention(nn.Module):
    """Fused-QKV multi-head self-attention: x·W in the compute dtype, the
    bias handed to the attention kernel."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.qkv = nn.Linear(config.n_embd, 3 * config.n_embd,
                             dtype=config.param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        qkv_nb = F.linear(x.to(cfg.dtype), self.qkv.weight.to(cfg.dtype))
        return fused_qkv_attention(qkv_nb, cfg.n_heads, causal=cfg.causal,
                                   qkv_bias=self.qkv.bias)


class Mlp(nn.Module):
    """fc1 → GELU → fc2, both matmuls in the compute dtype."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.fc1 = nn.Linear(config.n_embd, 4 * config.n_embd,
                             dtype=config.param_dtype, device=device)
        self.fc2 = nn.Linear(4 * config.n_embd, config.n_embd,
                             dtype=config.param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = gelu_op(linear(x, self.fc1, cfg.dtype), cfg.gelu_impl)
        return linear(h, self.fc2, cfg.dtype)


class TransformerLayer(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then + mlp(ln2(x))."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        _check_supported(config)
        self.ln1 = LayerNorm(config)
        self.attn = Attention(config, device=device)
        self.ln2 = LayerNorm(config)
        self.mlp = Mlp(config, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class Transformer(nn.Module):
    """Unrolled stack of ``n_layers`` blocks; the input is cast to the compute
    dtype on entry. ``layers.{i}`` holds the JAX tree's ``layer_{i}``."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(TransformerLayer(config, device=device)
                                    for _ in range(config.n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.config.dtype)
        for layer in self.layers:
            x = layer(x)
        return x
