"""LlamaGen-TiTok: TiTok over the discrete code sequences of a frozen VQGAN
(counterpart of ``vit_tpu/models/llamagen_titok.py:31-148``).

The encoder embeds the VQ's code indices (``tok_emb`` gather plus a
positional table), prepends K latent slots, runs the minimal transformer
over vq_latent_tokens + K positions and projects the K slot outputs to
latent_dim in fp32; the codes are quantized; the decoder projects them
back, prepends vq_latent_tokens mask tokens, runs its transformer and emits
fp32 logits over the VQ's codebook from the mask-token outputs. It trains
with cross-entropy against the input codes.

The gather is ``F.embedding``: its backward sums each code's rows in a
fixed order, where ``index_select``'s atomic adds would part two bf16 runs
from one seed. Init (``utils/init.py:init_llamagen_titok_``):
trunc_normal(0.02) on its own Linear weights and tables, zero biases,
N(0, 1/width) positional tables, the transformers as the minimal core's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.config import TransformerConfig, transformer_configs
from vit_tpu_torch.core.transformer import Transformer, linear
from vit_tpu_torch.quantize.vq import Quantizer


@dataclasses.dataclass(eq=False)
class LlamaGenTiTokConfig:
    vq_codebook_size: int
    vq_latent_tokens: int
    latent_tokens: int
    codebook_size: int
    latent_dim: int
    transformer: str
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    quant: Optional[str] = None    # "int8": serving-only int8 dense sites

    def __post_init__(self):
        self.trans_config: TransformerConfig = transformer_configs[
            self.transformer](block_size=self.vq_latent_tokens
                              + self.latent_tokens, dropout=0.0,
                              dtype=self.dtype, param_dtype=self.param_dtype,
                              quant=self.quant)
        self.n_embd = self.trans_config.n_embd


def _table(rows: int, cfg: LlamaGenTiTokConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(rows, cfg.n_embd, dtype=cfg.param_dtype,
                                    device=device))


class LlamaGenTiTokEncoder(nn.Module):
    """Code ids (B, vq_latent_tokens) → K latent vectors (B, K, latent_dim)
    fp32."""

    def __init__(self, config: LlamaGenTiTokConfig, device=None):
        super().__init__()
        self.config = config
        self.tok_emb = _table(config.vq_codebook_size, config, device)
        self.pos_emb = _table(config.vq_latent_tokens, config, device)
        self.extra_emb = _table(config.latent_tokens, config, device)
        self.transformer = Transformer(config.trans_config, device=device)
        self.proj = nn.Linear(config.n_embd, config.latent_dim,
                              dtype=config.param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        inp = (F.embedding(x.long(), self.tok_emb)
               + self.pos_emb[None, :x.shape[1]]).to(dt)
        extra = self.extra_emb.to(dt)[None].expand(x.shape[0], -1, -1)
        out = self.transformer(torch.cat([extra, inp], dim=1))
        return linear(out[:, :cfg.latent_tokens], self.proj, torch.float32)


class LlamaGenTiTokDecoder(nn.Module):
    """K quantized latents → logits (B, vq_latent_tokens, vq_codebook_size)
    fp32."""

    def __init__(self, config: LlamaGenTiTokConfig, device=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=config.param_dtype, device=device)
        self.pos_emb = _table(config.latent_tokens, config, device)
        self.mask_tokens = _table(config.vq_latent_tokens, config, device)
        self.quant_proj = nn.Linear(config.latent_dim, config.n_embd, **kw)
        self.transformer = Transformer(config.trans_config, device=device)
        self.emb_proj = nn.Linear(config.n_embd, config.vq_codebook_size,
                                  **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        z_emb = (linear(z, self.quant_proj, dt)
                 + self.pos_emb[None, :z.shape[1]].to(dt))
        mask = self.mask_tokens.to(dt)[None].expand(z.shape[0], -1, -1)
        out = self.transformer(torch.cat([mask, z_emb], dim=1))
        return linear(out[:, :cfg.vq_latent_tokens], self.emb_proj,
                      torch.float32)


class LlamaGenTiTok(nn.Module):
    """The token-space tokenizer: encoder, L2-norm VQ, decoder."""

    def __init__(self, config: LlamaGenTiTokConfig, device=None):
        super().__init__()
        self.config = config
        self.enc = LlamaGenTiTokEncoder(config, device=device)
        self.quant = Quantizer(config.codebook_size, config.latent_dim,
                               device=device)
        self.dec = LlamaGenTiTokDecoder(config, device=device)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, vq_latent_tokens) int codes → (logits, indices, quantize
        loss)."""
        quantized, indices, quantize_loss = self.quant(self.enc(x))
        return self.dec(quantized), indices, quantize_loss

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant(self.enc(x))[1]

    def decode(self, z_quant: torch.Tensor) -> torch.Tensor:
        return self.dec(z_quant)

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        return self.dec(self.quant.lookup(indices))
