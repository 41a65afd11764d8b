"""TiTok 1-D image tokenizer, the author's variant (counterpart of
``vit_tpu/models/titok.py:27-139``).

Encoder: ViT over the image with K latent slots prepended; keep the K latent
outputs and project them to latent_dim in fp32. Quantizer: the L2-norm VQ,
or FSQ under ``quantizer="fsq"`` (levels ``fsq_levels``, by default 8 for
each of the latent_dim channels), which has no codebook.
Decoder: project the codes back to n_embd (bf16), run them through a ViT as a
(K, 1) "image" with patch 1 whose extra tokens are the n_patches mask slots,
and turn the mask-slot outputs into pixels with an fp32 1×1 projection and
depth-to-space. Images are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from einops import rearrange
from torch import nn

from vit_tpu_torch.core.transformer import linear
from vit_tpu_torch.models.vit import ViT, ViTConfig
from vit_tpu_torch.quantize.vq import FSQ, Quantizer


@dataclasses.dataclass(eq=False)
class TiTokConfig:
    image_size: int
    patch_size: int
    latent_tokens: int
    codebook_size: int
    latent_dim: int
    transformer: str
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    quantizer: str = "vq"          # "vq" | "fsq"
    fsq_levels: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        self.grid_size = self.image_size // self.patch_size
        self.n_patches = self.grid_size ** 2
        kw = dict(dtype=self.dtype, param_dtype=self.param_dtype)
        # encoder ViT: image + K latent slots
        self.enc_vit_config = ViTConfig(self.image_size, 3, self.patch_size,
                                        self.transformer, self.latent_tokens,
                                        0.0, **kw)
        self.n_embd = self.enc_vit_config.trans_config.n_embd
        # decoder ViT: latents as a (K, 1) image, patch 1, n_patches mask
        # slots; n_patches is overridden to K, so pos_emb is (K, n_embd)
        self.dec_vit_config = ViTConfig(self.latent_tokens, self.n_embd, 1,
                                        self.transformer, self.n_patches, 0.0,
                                        **kw)
        self.dec_vit_config.n_patches = self.latent_tokens
        self.dec_vit_config.trans_config = (
            self.dec_vit_config.trans_config.replace(
                block_size=self.latent_tokens + self.n_patches))


class TiTokEncoder(nn.Module):
    """Image → K latent vectors."""

    def __init__(self, config: TiTokConfig, device=None):
        super().__init__()
        self.config = config
        self.vit = ViT(config.enc_vit_config, device=device)
        self.proj = nn.Linear(config.n_embd, config.latent_dim,
                              dtype=config.param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        latent = self.vit(x)[:, :self.config.latent_tokens]
        return linear(latent, self.proj, torch.float32)


class TiTokDecoder(nn.Module):
    """K quantised latents → image."""

    def __init__(self, config: TiTokConfig, device=None):
        super().__init__()
        self.config = config
        p = config.patch_size
        self.quant_proj = nn.Linear(config.latent_dim, config.n_embd,
                                    dtype=config.param_dtype, device=device)
        self.vit = ViT(config.dec_vit_config, device=device)
        self.embd_proj = nn.Linear(config.n_embd, 3 * p * p,
                                   dtype=config.param_dtype, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        p = cfg.patch_size
        z = linear(z, self.quant_proj, cfg.dtype)
        z = rearrange(z, "b k c -> b k 1 c")  # latents as a (K, 1) NHWC image
        out = self.vit(z)[:, :cfg.n_patches]  # the mask-slot outputs
        out = rearrange(out, "b (h w) c -> b h w c", h=cfg.grid_size,
                        w=cfg.grid_size)
        img = linear(out, self.embd_proj, torch.float32)  # 1×1 conv
        return rearrange(img, "b h w (p1 p2 c) -> b (h p1) (w p2) c", p1=p,
                         p2=p)


class TiTok(nn.Module):
    """Full tokenizer: encoder, quantizer, decoder."""

    def __init__(self, config: TiTokConfig, device=None):
        super().__init__()
        self.config = config
        self.enc = TiTokEncoder(config, device=device)
        if config.quantizer == "fsq":
            self.quant = FSQ(config.fsq_levels or (8,) * config.latent_dim)
        else:
            self.quant = Quantizer(config.codebook_size, config.latent_dim,
                                   device=device)
        self.dec = TiTokDecoder(config, device=device)

    def forward(self, x: torch.Tensor):
        """Image → (reconstruction, indices, quantize loss)."""
        quantized, indices, quantize_loss = self.quant(self.enc(x))
        return self.dec(quantized), indices, quantize_loss

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Image → code indices (int32)."""
        return self.quant(self.enc(x))[1]

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """Code indices → image. FSQ has no lookup, as in the JAX package."""
        if self.config.quantizer == "fsq":
            raise NotImplementedError(
                "decode_indices of an FSQ TiTok: FSQ has no index lookup "
                "(neither has the JAX package's)")
        return self.dec(self.quant.lookup(indices))
