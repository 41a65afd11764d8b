"""TATiTok, the Bytedance-blocks TiTok variant (counterpart of
``vit_tpu/models/tatitok.py``).

The encoder takes the image's patches behind a class embedding, with their
own positional table, and the wrapper's learned latent bank with its
positional table; ``ln_pre`` before and ``ln_post`` after the transformer
(affine fp32 LayerNorms, eps 1e-5), then an fp32 dense ``conv_out`` (the
1×1 conv) of the latent outputs. The decoder puts one broadcast mask token
a patch behind the class embedding, the projected codes after them and,
under ``text_guidance``, the projected text tokens with their positional
table last; after the transformer and ``ln_post``, the patch outputs go
through the fp32 depth-to-space ``ffn`` and a real 3×3 fp32 ``conv_out``
with SAME padding. The quantizer is ``BytedanceVectorQuantizer``.

The transformers are the Bytedance preset (``bytedance_config``: affine
LayerNorms, an attention output projection), at dropout 0, computing in
``dtype`` (bf16 by default) with fp32 parameters. Activations are batch
first and channels last: images (B, H, W, 3). Module names follow the flax
tree, so ``bridge.tatitok_state_dict_from_flax`` carries JAX weights over.
``init_tatitok_`` (``utils/init.py``) draws fresh ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from vit_tpu_torch.core.config import BYTEDANCE_WIDTH, bytedance_config
from vit_tpu_torch.core.transformer import Transformer, linear
from vit_tpu_torch.quantize.bytedance_vq import BytedanceVectorQuantizer


@dataclasses.dataclass(eq=False)
class TATiTokConfig:
    """``vit_tpu/models/tatitok.py:TATiTokConfig``'s fields that the port
    runs (no ``attn_impl``, ``scan_layers`` or pipeline stages), and the
    transformer's ``remat``; ``quant`` "int8" makes the transformers' dense
    sites int8 for serving."""

    image_size: int
    patch_size: int
    latent_tokens: int
    codebook_size: int
    latent_dim: int
    transformer: str               # "small" | "base" | "large"
    use_l2_norm: bool = True
    clustering_vq: bool = False
    text_guidance: bool = False
    text_context_length: int = 77
    text_embed_dim: int = 768
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    quant: Optional[str] = None

    def __post_init__(self):
        self.grid_size = self.image_size // self.patch_size
        self.width = BYTEDANCE_WIDTH[self.transformer]
        seq = self.grid_size ** 2 + 1 + self.latent_tokens
        if self.text_guidance:
            seq += self.text_context_length
        self.trans_config = bytedance_config(
            self.transformer, block_size=seq, dropout=0.0, dtype=self.dtype,
            param_dtype=self.param_dtype, remat=self.remat, quant=self.quant)


def _ln(width: int, config: TATiTokConfig, device) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=1e-5, dtype=config.param_dtype,
                        device=device)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)``: x in fp32 → fp32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


class TATiTokEncoder(nn.Module):
    """Image + latent bank → (B, K, latent_dim) fp32 latents."""

    def __init__(self, config: TATiTokConfig, device=None):
        super().__init__()
        self.config = config
        w, p = config.width, config.patch_size
        kw = dict(dtype=config.param_dtype, device=device)
        self.patch_embed = nn.Linear(p * p * 3, w, **kw)
        self.class_embedding = nn.Parameter(torch.empty(1, w, **kw))
        self.positional_embedding = nn.Parameter(
            torch.empty(config.grid_size ** 2 + 1, w, **kw))
        self.latent_token_positional_embedding = nn.Parameter(
            torch.empty(config.latent_tokens, w, **kw))
        self.ln_pre = _ln(w, config, device)
        self.transformer = Transformer(config.trans_config, device=device)
        self.ln_post = _ln(w, config, device)
        self.conv_out = nn.Linear(w, config.latent_dim, **kw)

    def forward(self, pixels: torch.Tensor,
                latent_tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt, w, b = cfg.dtype, cfg.width, pixels.shape[0]
        x = rearrange(pixels, "b (h p1) (w p2) c -> b (h w) (p1 p2 c)",
                      p1=cfg.patch_size, p2=cfg.patch_size)
        x = linear(x, self.patch_embed, dt)
        cls = self.class_embedding.to(dt)[None].expand(b, 1, w)
        x = torch.cat([cls, x], 1) + self.positional_embedding.to(dt)[None]
        lat = (latent_tokens.to(dt)[None].expand(b, -1, -1)
               + self.latent_token_positional_embedding.to(dt)[None])
        x = torch.cat([x, lat], 1)
        x = self.transformer(_layer_norm(x, self.ln_pre).to(dt))
        lat_out = _layer_norm(x[:, 1 + cfg.grid_size ** 2:], self.ln_post)
        return linear(lat_out, self.conv_out, torch.float32)


class TATiTokDecoder(nn.Module):
    """Quantized latents (+ text guidance) → (B, H, W, 3) fp32 image."""

    def __init__(self, config: TATiTokConfig, device=None):
        super().__init__()
        self.config = config
        w, p = config.width, config.patch_size
        kw = dict(dtype=config.param_dtype, device=device)
        self.decoder_embed = nn.Linear(config.latent_dim, w, **kw)
        self.class_embedding = nn.Parameter(torch.empty(1, w, **kw))
        self.positional_embedding = nn.Parameter(
            torch.empty(config.grid_size ** 2 + 1, w, **kw))
        self.mask_token = nn.Parameter(torch.empty(1, 1, w, **kw))
        self.latent_token_positional_embedding = nn.Parameter(
            torch.empty(config.latent_tokens, w, **kw))
        if config.text_guidance:
            self.text_guidance_positional_embedding = nn.Parameter(
                torch.empty(config.text_context_length, w, **kw))
            self.text_guidance_proj = nn.Linear(config.text_embed_dim, w,
                                                **kw)
        self.ln_pre = _ln(w, config, device)
        self.transformer = Transformer(config.trans_config, device=device)
        self.ln_post = _ln(w, config, device)
        self.ffn = nn.Linear(w, p * p * 3, **kw)
        self.conv_out = nn.Conv2d(3, 3, 3, padding=1, **kw)

    def forward(self, z: torch.Tensor,
                text_guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        dt, w, p = cfg.dtype, cfg.width, cfg.patch_size
        b, seq_len, _ = z.shape
        grid2 = cfg.grid_size ** 2
        x = linear(z, self.decoder_embed, dt)
        mask = self.mask_token.to(dt).expand(b, grid2, w)
        cls = self.class_embedding.to(dt)[None].expand(b, 1, w)
        mask = (torch.cat([cls, mask], 1)
                + self.positional_embedding.to(dt)[None])
        x = x + self.latent_token_positional_embedding.to(dt)[None, :seq_len]
        x = torch.cat([mask, x], 1)
        if cfg.text_guidance:
            if text_guidance is None:
                raise ValueError(
                    "text_guidance tensor required (B, ctx, text_dim)")
            tg = (linear(text_guidance, self.text_guidance_proj, dt)
                  + self.text_guidance_positional_embedding.to(dt)[None])
            x = torch.cat([x, tg], 1)
        x = self.transformer(_layer_norm(x, self.ln_pre).to(dt))
        x = _layer_norm(x[:, 1:1 + grid2], self.ln_post)
        img = linear(x, self.ffn, torch.float32)
        img = rearrange(img, "b (h w) (p1 p2 c) -> b c (h p1) (w p2)",
                        h=cfg.grid_size, p1=p, p2=p)
        img = F.conv2d(img, self.conv_out.weight.float(),
                       self.conv_out.bias.float(), padding=1)
        return img.permute(0, 2, 3, 1)


class TATiTok(nn.Module):
    """The latent bank, the encoder, the quantizer and the decoder."""

    def __init__(self, config: TATiTokConfig, device=None):
        super().__init__()
        self.config = config
        self.encoder = TATiTokEncoder(config, device=device)
        self.decoder = TATiTokDecoder(config, device=device)
        self.latent_tokens = nn.Parameter(torch.empty(
            config.latent_tokens, config.width, dtype=config.param_dtype,
            device=device))
        self.quantize = BytedanceVectorQuantizer(
            config.codebook_size, config.latent_dim, commitment_cost=0.25,
            use_l2_norm=config.use_l2_norm,
            clustering_vq=config.clustering_vq, device=device)

    def encode(self, x: torch.Tensor, train: bool = False
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Image → (quantized latents, the quantizer's result dict);
        ``train`` runs the clustering update."""
        return self.quantize(self.encoder(x, self.latent_tokens), train)

    def decode(self, z_quantized: torch.Tensor,
               text_guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder(z_quantized, text_guidance)

    def decode_tokens(self, tokens: torch.Tensor,
                      text_guidance: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Code indices (B, K) → image."""
        z = self.quantize.get_codebook_entry(tokens.reshape(-1)).reshape(
            tokens.shape[0], tokens.shape[-1], -1)
        return self.decode(z, text_guidance)

    def forward(self, x: torch.Tensor,
                text_guidance: Optional[torch.Tensor] = None,
                train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Image → (reconstruction, the quantizer's result dict)."""
        z_quantized, result = self.encode(x, train)
        return self.decode(z_quantized, text_guidance), result
