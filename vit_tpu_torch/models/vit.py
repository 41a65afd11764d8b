"""ViT backbone (counterpart of ``vit_tpu/models/vit.py:26-112``).

Images are NHWC, as in the JAX package. The patch embedding is the same
unfold + Linear in ``(p1 p2 c)`` order (a stride-patch conv written as one
GEMM), so the two packages share one weight layout.
"""

from __future__ import annotations

import dataclasses

import torch
from einops import rearrange
from torch import nn

from vit_tpu_torch.core.config import TransformerConfig, transformer_configs
from vit_tpu_torch.core.transformer import Transformer, linear


@dataclasses.dataclass(eq=False)
class ViTConfig:
    """``n_patches`` is derived in ``__post_init__`` but stays overridable: the
    TiTok decoder sets it after construction."""

    image_size: int
    in_channels: int
    patch_size: int
    transformer: str
    extra_tokens: int
    dropout: float
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.n_patches = (self.image_size // self.patch_size) ** 2
        self.trans_config: TransformerConfig = transformer_configs[
            self.transformer](block_size=self.n_patches + self.extra_tokens,
                              dropout=self.dropout, dtype=self.dtype,
                              param_dtype=self.param_dtype)


class PatchEmbed(nn.Module):
    """Stride-patch conv as unfold + Linear, in the compute dtype."""

    def __init__(self, patch_size: int, n_embd: int, in_channels: int,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Linear(patch_size * patch_size * in_channels, n_embd,
                              dtype=param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        x = rearrange(x, "b (h p1) (w p2) c -> b (h w) (p1 p2 c)", p1=p, p2=p)
        return linear(x, self.proj, self.dtype)


class ViT(nn.Module):
    """Patch embed → + pos_emb → prepend ``extra_tokens`` learned embeddings →
    Transformer. Returns all tokens, extra tokens first."""

    def __init__(self, config: ViTConfig, device=None):
        super().__init__()
        self.config = config
        tc = config.trans_config
        self.patch_proj = PatchEmbed(config.patch_size, tc.n_embd,
                                     config.in_channels, dtype=tc.dtype,
                                     param_dtype=tc.param_dtype, device=device)
        self.pos_emb = nn.Parameter(torch.empty(
            config.n_patches, tc.n_embd, dtype=tc.param_dtype, device=device))
        if config.extra_tokens > 0:
            self.extra_emb = nn.Parameter(torch.empty(
                config.extra_tokens, tc.n_embd, dtype=tc.param_dtype,
                device=device))
        self.transformer = Transformer(tc, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = cfg.trans_config.dtype
        emb = self.patch_proj(x) + self.pos_emb.to(dt)
        if cfg.extra_tokens > 0:
            extra = self.extra_emb.to(dt)[None].expand(x.shape[0], -1, -1)
            emb = torch.cat([extra, emb], dim=1)
        return self.transformer(emb)
