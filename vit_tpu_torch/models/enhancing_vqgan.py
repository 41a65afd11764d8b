"""The "enhancing" ViT-VQGAN (counterpart of
``vit_tpu/models/enhancing_vqgan.py:56-293``), a self-contained variant with
its own transformer.

What differs from the minimal-core ViT-VQGAN:
  - fixed 2-D sin/cos positional tables (``models/mae.py:pos_table``,
    the port's copy of the JAX function), added in the compute dtype;
  - its own pre-norm block: flax LayerNorms (``losses/perceptual.py:
    LayerNorm``: eps 1e-6, statistics and the affine in fp32, output in the
    compute dtype), a bias-free fused
    QKV whose attention runs through ``fused_qkv_attention`` with no bias
    (K1/K2 on the card), an output projection, a Tanh feed-forward in the
    compute dtype, and a final LayerNorm after the stack;
  - fp32 ``pre_quant_proj`` before the codebook and a ``quant_proj`` in the
    compute dtype after it;
  - the ConvTranspose2d(k = s = patch) pixel head, which is exactly one
    fp32 per-token Linear and depth-to-space.

Dims are fixed at ViT-B (768, 12 layers, 12 heads × 64, MLP 3072), as in the
JAX package. The blocks' names follow its flat ``attn_norm_{i}``, ``attn_{i}``,
``ff_norm_{i}``, ``ff1_{i}``, ``ff2_{i}`` as ``blocks.{i}.attn_norm`` and so
on (``bridge.py``). Init is Xavier-uniform with zero biases
(``utils/init.py:init_enhancing_``).
"""

from __future__ import annotations

import dataclasses

import torch
from einops import rearrange
from torch import nn

from vit_tpu_torch.core.transformer import linear
from vit_tpu_torch.losses.perceptual import LayerNorm
from vit_tpu_torch.models.mae import pos_table
from vit_tpu_torch.ops.attention import fused_qkv_attention
from vit_tpu_torch.quantize.vq import Quantizer


@dataclasses.dataclass(eq=False)
class EnhancingVQGANConfig:
    image_size: int
    patch_size: int
    codebook_size: int
    latent_dim: int
    transformer: str = "B"   # accepted for config parity; the dims are fixed
    dim: int = 768
    depth: int = 12
    heads: int = 12
    dim_head: int = 64
    mlp_dim: int = 3072
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.grid_size = self.image_size // self.patch_size
        self.n_patches = self.grid_size ** 2
        self.latent_tokens = self.n_patches


class EnhancingAttention(nn.Module):
    """Bias-free fused QKV, attention, output projection, in the compute
    dtype."""

    def __init__(self, config: EnhancingVQGANConfig, device=None):
        super().__init__()
        self.config = config
        inner = config.dim_head * config.heads
        kw = dict(dtype=config.param_dtype, device=device)
        self.to_qkv = nn.Linear(config.dim, 3 * inner, bias=False, **kw)
        self.to_out = nn.Linear(inner, config.dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        qkv = linear(x, self.to_qkv, cfg.dtype)
        out = fused_qkv_attention(qkv, cfg.heads, qkv_bias=None)
        return linear(out, self.to_out, cfg.dtype)


class EnhancingBlock(nn.Module):
    """x + attn(LN(x)), then + ff2(tanh(ff1(LN(x))))."""

    def __init__(self, config: EnhancingVQGANConfig, device=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=config.param_dtype, device=device)
        self.attn_norm = LayerNorm(config.dim, config.dtype, device=device)
        self.attn = EnhancingAttention(config, device=device)
        self.ff_norm = LayerNorm(config.dim, config.dtype, device=device)
        self.ff1 = nn.Linear(config.dim, config.mlp_dim, **kw)
        self.ff2 = nn.Linear(config.mlp_dim, config.dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        x = x + self.attn(self.attn_norm(x))
        h = torch.tanh(linear(self.ff_norm(x), self.ff1, dt))
        return x + linear(h, self.ff2, dt)


class EnhancingTransformer(nn.Module):
    """``depth`` blocks, then ``final_norm``; in and out in the compute
    dtype."""

    def __init__(self, config: EnhancingVQGANConfig, device=None):
        super().__init__()
        self.config = config
        self.blocks = nn.ModuleList(EnhancingBlock(config, device=device)
                                    for _ in range(config.depth))
        self.final_norm = LayerNorm(config.dim, config.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.config.dtype)
        for block in self.blocks:
            x = block(x)
        return self.final_norm(x)


def _pos(config: EnhancingVQGANConfig, like: torch.Tensor) -> torch.Tensor:
    """The fixed table on ``like``'s device, in the compute dtype."""
    return pos_table(config.dim, config.grid_size,
                     str(like.device)).to(config.dtype)


class EnhancingEncoder(nn.Module):
    """Patch embed (compute dtype) + the fixed table + the transformer."""

    def __init__(self, config: EnhancingVQGANConfig, device=None):
        super().__init__()
        self.config = config
        p = config.patch_size
        self.patch_embed = nn.Linear(p * p * 3, config.dim,
                                     dtype=config.param_dtype, device=device)
        self.transformer = EnhancingTransformer(config, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        p = cfg.patch_size
        x = rearrange(x, "b (h p1) (w p2) c -> b (h w) (p1 p2 c)", p1=p, p2=p)
        x = linear(x, self.patch_embed, cfg.dtype)
        x = x + _pos(cfg, x)
        return self.transformer(x)


class EnhancingDecoder(nn.Module):
    """The fixed table + the transformer + the fp32 pixel head."""

    def __init__(self, config: EnhancingVQGANConfig, device=None):
        super().__init__()
        self.config = config
        p = config.patch_size
        self.transformer = EnhancingTransformer(config, device=device)
        self.to_pixel = nn.Linear(config.dim, p * p * 3,
                                  dtype=config.param_dtype, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        p = cfg.patch_size
        x = self.transformer(z + _pos(cfg, z))
        # ConvTranspose2d(k = s = p) ≡ per-token Linear + depth-to-space
        img = linear(x, self.to_pixel, torch.float32)
        return rearrange(img, "b (h w) (p1 p2 c) -> b (h p1) (w p2) c",
                         h=cfg.grid_size, p1=p, p2=p)


class EnhancingViTVQGAN(nn.Module):
    """Encoder, fp32 pre-quant projection, quantizer, post-quant projection
    in the compute dtype, decoder."""

    def __init__(self, config: EnhancingVQGANConfig, device=None):
        super().__init__()
        self.config = config
        kw = dict(dtype=config.param_dtype, device=device)
        self.encoder = EnhancingEncoder(config, device=device)
        self.pre_quant_proj = nn.Linear(config.dim, config.latent_dim, **kw)
        self.quant = Quantizer(config.codebook_size, config.latent_dim,
                               device=device)
        self.quant_proj = nn.Linear(config.latent_dim, config.dim, **kw)
        self.decoder = EnhancingDecoder(config, device=device)

    def _latent(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.encoder(x), self.pre_quant_proj, torch.float32)

    def forward(self, x: torch.Tensor):
        """Image → (reconstruction, indices, quantize loss)."""
        quantized, indices, quantize_loss = self.quant(self._latent(x))
        return self.decode(quantized), indices, quantize_loss

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Image → code indices (int32), one a patch."""
        return self.quant(self._latent(x))[1]

    def decode(self, z_quant: torch.Tensor) -> torch.Tensor:
        return self.decoder(linear(z_quant, self.quant_proj,
                                   self.config.dtype))

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        return self.decode(self.quant.lookup(indices))

    def get_last_layer(self) -> torch.Tensor:
        """The pixel head's weight, for GAN-style adaptive loss weighting.
        The port's (out, in) layout; the JAX kernel is its transpose."""
        return self.decoder.to_pixel.weight
