"""ViT-VQGAN, the per-patch tokenizer (counterpart of
``vit_tpu/models/vit_vqgan.py:24-127``).

TiTok's skeleton with one latent per patch: latent_tokens = n_patches, the
encoder ViT has no extra tokens and every output is projected to latent_dim
in fp32; the decoder projects the codes back to n_embd in the compute dtype,
runs them through a ViT as a (K, 1) image with patch 1 and no extra tokens,
and turns every position back into a patch with an fp32 1×1 projection and
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
class ViTVQGANConfig:
    image_size: int
    patch_size: int
    codebook_size: int
    latent_dim: int
    transformer: str
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    quantizer: str = "vq"          # "vq" | "fsq"
    fsq_levels: Optional[Tuple[int, ...]] = None
    quant: Optional[str] = None    # "int8": serving-only int8 dense sites

    def __post_init__(self):
        self.grid_size = self.image_size // self.patch_size
        self.n_patches = self.grid_size ** 2
        self.latent_tokens = self.n_patches
        kw = dict(dtype=self.dtype, param_dtype=self.param_dtype,
                  quant=self.quant)
        self.enc_vit_config = ViTConfig(self.image_size, 3, self.patch_size,
                                        self.transformer, 0, 0.0, **kw)
        self.n_embd = self.enc_vit_config.trans_config.n_embd
        # the latents as a (K, 1) image, patch 1: n_patches is overridden to
        # K, so pos_emb is (K, n_embd) and S = K
        self.dec_vit_config = ViTConfig(self.latent_tokens, self.n_embd, 1,
                                        self.transformer, 0, 0.0, **kw)
        self.dec_vit_config.n_patches = self.latent_tokens
        self.dec_vit_config.trans_config = (
            self.dec_vit_config.trans_config.replace(
                block_size=self.latent_tokens))


class ViTVQGANEncoder(nn.Module):
    """Image → one latent per patch."""

    def __init__(self, config: ViTVQGANConfig, device=None):
        super().__init__()
        self.vit = ViT(config.enc_vit_config, device=device)
        self.proj = nn.Linear(config.n_embd, config.latent_dim,
                              dtype=config.param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.vit(x), self.proj, torch.float32)


class ViTVQGANDecoder(nn.Module):
    """Per-patch latents → image."""

    def __init__(self, config: ViTVQGANConfig, device=None):
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
        out = self.vit(rearrange(z, "b k c -> b k 1 c"))
        out = rearrange(out, "b (h w) c -> b h w c", h=cfg.grid_size,
                        w=cfg.grid_size)
        img = linear(out, self.embd_proj, torch.float32)  # 1×1 conv
        return rearrange(img, "b h w (p1 p2 c) -> b (h p1) (w p2) c", p1=p,
                         p2=p)


class ViTVQGAN(nn.Module):
    """Encoder, quantizer (VQ or FSQ), decoder."""

    def __init__(self, config: ViTVQGANConfig, device=None):
        super().__init__()
        self.config = config
        self.encoder = ViTVQGANEncoder(config, device=device)
        if config.quantizer == "fsq":
            self.quant = FSQ(config.fsq_levels or (8,) * config.latent_dim)
        else:
            self.quant = Quantizer(config.codebook_size, config.latent_dim,
                                   device=device)
        self.decoder = ViTVQGANDecoder(config, device=device)

    def forward(self, x: torch.Tensor):
        """Image → (reconstruction, indices, quantize loss)."""
        quantized, indices, quantize_loss = self.quant(self.encoder(x))
        return self.decoder(quantized), indices, quantize_loss

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Image → code indices (int32), one a patch."""
        return self.quant(self.encoder(x))[1]

    def decode(self, z_quant: torch.Tensor) -> torch.Tensor:
        return self.decoder(z_quant)

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """Code indices → image. FSQ has no lookup, as in the JAX package."""
        if self.config.quantizer == "fsq":
            raise NotImplementedError(
                "decode_indices of an FSQ ViT-VQGAN: FSQ has no index lookup "
                "(neither has the JAX package's)")
        return self.decoder(self.quant.lookup(indices))
