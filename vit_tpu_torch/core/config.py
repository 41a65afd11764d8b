"""Transformer configuration and size presets (counterpart of
``vit_tpu/core/config.py:19-132``).

Parameters are fp32 (``param_dtype``) and compute is bf16 (``dtype``), cast
explicitly at each matmul. ``ln_affine`` and ``attn_out_proj`` select the
Bytedance block layout (affine LayerNorms, an attention output projection),
which ``bytedance_config`` sets for the Bytedance presets. ``quant``
("int8") runs the blocks' dense sites as int8 products for serving
(``core/quant.py``). ``remat``
recomputes each block in the backward (``torch.utils.checkpoint``) under
``remat_policy`` (``core/transformer.py:remat_policy``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Pre-LN transformer hyperparameters."""

    n_layers: int
    n_heads: int
    n_embd: int
    block_size: int
    causal: bool = False
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16        # compute dtype
    param_dtype: torch.dtype = torch.float32   # parameter dtype
    gelu_impl: Optional[str] = None            # None → $VIT_TPU_GELU → "tanh_erf"
    fused_ln: Optional[bool] = None            # pre-LN fused into the qkv/fc1
                                               # product (kernels/ln_matmul.py);
                                               # None = off; $VIT_TPU_FUSED_LN
                                               # overrides
    fused_fc_grad: Optional[bool] = None       # dW and db of the MLP products
                                               # in one pass (kernels/fc_grad.py);
                                               # None = off; $VIT_TPU_FUSED_FC
                                               # overrides
    ln_affine: bool = False
    attn_out_proj: bool = False
    quant: Optional[str] = None                # None | "int8": serving-only
                                               # int8 products at the dense
                                               # sites (core/quant.py)
    remat: bool = False                        # recompute each block in the
                                               # backward
    remat_policy: Optional[str] = None         # None → $VIT_TPU_REMAT_POLICY
                                               # → "everything" | "dots" |
                                               # "dots_no_batch": what the
                                               # recompute keeps

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


def S(**kwargs) -> TransformerConfig:
    """Small preset: 6L/8H/512."""
    return TransformerConfig(n_layers=6, n_heads=8, n_embd=512, **kwargs)


def B(**kwargs) -> TransformerConfig:
    """Base preset: 12L/12H/768."""
    return TransformerConfig(n_layers=12, n_heads=12, n_embd=768, **kwargs)


def L(**kwargs) -> TransformerConfig:
    """Large preset: 24L/16H/1024."""
    return TransformerConfig(n_layers=24, n_heads=16, n_embd=1024, **kwargs)


transformer_configs = {"S": S, "B": B, "L": L}

# The Bytedance TiTok presets (``vit_tpu/core/config.py:116-132``):
# width, layers and heads by model size
BYTEDANCE_WIDTH = {"small": 512, "base": 768, "large": 1024}
BYTEDANCE_LAYERS = {"small": 8, "base": 12, "large": 24}
BYTEDANCE_HEADS = {"small": 8, "base": 12, "large": 16}


def bytedance_config(model_size: str, block_size: int,
                     **kwargs) -> TransformerConfig:
    """The Bytedance preset ``model_size`` with affine LayerNorms and an
    attention output projection."""
    return TransformerConfig(n_layers=BYTEDANCE_LAYERS[model_size],
                             n_heads=BYTEDANCE_HEADS[model_size],
                             n_embd=BYTEDANCE_WIDTH[model_size],
                             block_size=block_size, ln_affine=True,
                             attn_out_proj=True, **kwargs)
