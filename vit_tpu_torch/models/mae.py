"""MAE, masked-autoencoder pretraining (counterpart of
``vit_tpu/models/mae.py``; He et al., arXiv 2111.06377).

Each image keeps a fixed count ``len_keep`` of its patches, chosen by an
argsort of a uniform noise vector (static shapes). The encoder sees the
visible patches, with fixed 2-D sin/cos positions and a cls token; the
decoder projects them to its width, puts a learned mask token in every
removed slot, unshuffles the sequence back to patch order by a gather
over ``ids_restore``, adds its own sin/cos positions (the cls token gets
none) and predicts each patch's pixels through an fp32 ``pred`` layer.

The JAX module draws its noise from a flax ``mask`` stream; here
``MAE.forward`` takes the noise (B, n_patches) as an argument or draws it
from an explicit ``torch.Generator``. The parity tests pass JAX's own
draw. At the defaults (image 256, patch 16, decoder 16 heads × 512) the
decoder's attention runs the kernels at head_dim 32 and S 257, the
encoder's at head_dim 64 and S 65.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from einops import rearrange
from torch import nn

from vit_tpu_torch.core.config import TransformerConfig, transformer_configs
from vit_tpu_torch.core.transformer import Transformer, linear
from vit_tpu_torch.models.vit import PatchEmbed


@dataclasses.dataclass(eq=False)
class MAEConfig:
    """MAE hyperparameters (``vit_tpu/models/mae.py:MAEConfig``): the encoder
    follows the S/B/L presets, the decoder is the paper's 8 layers × 16
    heads × 512 by default."""

    image_size: int
    in_channels: int = 3
    patch_size: int = 16
    transformer: str = "B"
    mask_ratio: float = 0.75
    decoder_layers: int = 8
    decoder_heads: int = 16
    decoder_embd: int = 512
    dropout: float = 0.0
    norm_pix: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.grid_size = self.image_size // self.patch_size
        self.n_patches = self.grid_size ** 2
        self.patch_dim = self.in_channels * self.patch_size ** 2
        # Python's round, as the JAX config (half to even)
        self.len_keep = max(1, int(round(self.n_patches
                                         * (1.0 - self.mask_ratio))))
        # +1: the cls token rides along in both stacks
        self.enc_config: TransformerConfig = transformer_configs[
            self.transformer](block_size=self.len_keep + 1,
                              dropout=self.dropout, dtype=self.dtype,
                              param_dtype=self.param_dtype)
        self.dec_config = TransformerConfig(
            n_layers=self.decoder_layers, n_heads=self.decoder_heads,
            n_embd=self.decoder_embd, block_size=self.n_patches + 1,
            dropout=self.dropout, dtype=self.dtype,
            param_dtype=self.param_dtype)


def sincos_2d_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """Fixed 2-D sin/cos embeddings (the port's copy of
    ``vit_tpu/models/enhancing_vqgan.py:sincos_2d_pos_embed``): half the
    channels encode the row coordinate, half the column, each as
    [sin(pos·ω), cos(pos·ω)] with ω_k = 1/10000^(2k/D), in float64, then
    float32. (grid², embed_dim); the grid is ``xy``-indexed as
    ``np.meshgrid``'s default."""
    if embed_dim % 4:
        raise ValueError(f"embed_dim must be a multiple of 4, got {embed_dim}")

    def one_axis(pos):
        dim = embed_dim // 2
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_w, grid_h = np.meshgrid(np.arange(grid_size, dtype=np.float32),
                                 np.arange(grid_size, dtype=np.float32))
    return np.concatenate([one_axis(grid_h), one_axis(grid_w)],
                          axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def pos_table(embed_dim: int, grid_size: int,
              device: str = "cpu") -> torch.Tensor:
    """``sincos_2d_pos_embed`` as an fp32 tensor on ``device``, made once
    per (width, grid, device)."""
    return torch.from_numpy(sincos_2d_pos_embed(embed_dim, grid_size)).to(
        device)


def random_masking(noise: torch.Tensor, len_keep: int):
    """Per-image masking from a (B, N) noise tensor by a stable argsort
    (``vit_tpu/models/mae.py:random_masking``): ``ids_keep`` (B, len_keep),
    the visible patches; ``ids_restore`` (B, N), the inverse permutation
    that unshuffles the decoder's sequence; ``mask`` (B, N) fp32, 1 where a
    patch was removed."""
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    mask = torch.ones(noise.shape, dtype=torch.float32, device=noise.device)
    mask[:, :len_keep] = 0.0
    return ids_keep, ids_restore, torch.gather(mask, 1, ids_restore)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) → (B, n_patches, p·p·C), PatchEmbed's token order."""
    return rearrange(images, "b (h p1) (w p2) c -> b (h w) (p1 p2 c)",
                     p1=patch_size, p2=patch_size)


def unpatchify(patches: torch.Tensor, patch_size: int, grid_size: int,
               in_channels: int = 3) -> torch.Tensor:
    """Inverse of :func:`patchify`: (B, n, p·p·C) → (B, H, W, C)."""
    return rearrange(patches, "b (h w) (p1 p2 c) -> b (h p1) (w p2) c",
                     h=grid_size, w=grid_size, p1=patch_size, p2=patch_size,
                     c=in_channels)


def _take(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x (B, N, D) at the rows ``ids`` (B, M) of each image: (B, M, D)."""
    return torch.gather(x, 1, ids[:, :, None].expand(-1, -1, x.shape[-1]))


class MAEEncoder(nn.Module):
    """Patch embed + fixed sin/cos positions → the visible tokens → cls →
    transformer."""

    def __init__(self, config: MAEConfig, device=None):
        super().__init__()
        self.config = config
        tc = config.enc_config
        self.patch_proj = PatchEmbed(config.patch_size, tc.n_embd,
                                     config.in_channels, dtype=tc.dtype,
                                     param_dtype=tc.param_dtype, device=device)
        self.cls_token = nn.Parameter(torch.empty(
            1, tc.n_embd, dtype=tc.param_dtype, device=device))
        self.transformer = Transformer(tc, device=device)

    def forward(self, images: torch.Tensor, ids_keep: torch.Tensor,
                generator: "torch.Generator | None" = None) -> torch.Tensor:
        cfg = self.config
        dt = cfg.enc_config.dtype
        pos = pos_table(cfg.enc_config.n_embd, cfg.grid_size,
                        str(images.device))
        x = self.patch_proj(images) + pos.to(dt)[None]
        x = _take(x, ids_keep)
        cls = self.cls_token.to(dt)[None].expand(x.shape[0], -1, -1)
        return self.transformer(torch.cat([cls, x], dim=1),
                                generator=generator)


class MAEDecoder(nn.Module):
    """Project to the decoder's width, unshuffle with mask tokens, predict
    each patch's pixels in fp32."""

    def __init__(self, config: MAEConfig, device=None):
        super().__init__()
        self.config = config
        dc = config.dec_config
        self.embed = nn.Linear(config.enc_config.n_embd, dc.n_embd,
                               dtype=dc.param_dtype, device=device)
        self.mask_token = nn.Parameter(torch.empty(
            1, dc.n_embd, dtype=dc.param_dtype, device=device))
        self.transformer = Transformer(dc, device=device)
        self.pred = nn.Linear(dc.n_embd, config.patch_dim,
                              dtype=dc.param_dtype, device=device)

    def forward(self, latent: torch.Tensor, ids_restore: torch.Tensor,
                generator: "torch.Generator | None" = None) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dec_config.dtype
        x = linear(latent, self.embed, dt)
        b, n_masked = x.shape[0], cfg.n_patches - cfg.len_keep
        masked = self.mask_token.to(dt)[None].expand(b, n_masked, -1)
        # the visible tokens (without cls) ++ mask tokens, back in patch order
        x_ = _take(torch.cat([x[:, 1:], masked], dim=1), ids_restore)
        pos = pos_table(cfg.dec_config.n_embd, cfg.grid_size,
                        str(latent.device))
        x_ = x_ + pos.to(dt)[None]
        x = self.transformer(torch.cat([x[:, :1], x_], dim=1),
                             generator=generator)
        # fp32 input, fp32 product: the JAX Dense at dtype float32
        return linear(x[:, 1:].float(), self.pred, torch.float32)


class MAE(nn.Module):
    """The masked autoencoder. ``forward(images, noise=None, generator=None)
    → (pred, mask)``: ``pred`` (B, n_patches, patch_dim) fp32 and ``mask``
    (B, n_patches), 1 on the removed (predicted) patches. Without ``noise``
    it is drawn, U[0, 1), from ``generator`` on the images' device; the
    transformers' dropout draws from it too while training."""

    def __init__(self, config: MAEConfig, device=None):
        super().__init__()
        self.config = config
        self.encoder = MAEEncoder(config, device=device)
        self.decoder = MAEDecoder(config, device=device)

    def forward(self, images: torch.Tensor,
                noise: "torch.Tensor | None" = None,
                generator: "torch.Generator | None" = None):
        cfg = self.config
        if noise is None:
            noise = torch.rand(images.shape[0], cfg.n_patches,
                               generator=generator, device=images.device)
        ids_keep, ids_restore, mask = random_masking(noise.to(images.device),
                                                     cfg.len_keep)
        latent = self.encoder(images, ids_keep, generator)
        return self.decoder(latent, ids_restore, generator), mask

    def reconstruct(self, images: torch.Tensor,
                    noise: "torch.Tensor | None" = None,
                    generator: "torch.Generator | None" = None):
        """The full image for eval grids: masked patches from the
        prediction, visible ones from the input. → (images (B, H, W, C)
        fp32, mask)."""
        cfg = self.config
        pred, mask = self(images, noise, generator)
        target = patchify(images.float(), cfg.patch_size)
        mixed = torch.where(mask[:, :, None] > 0, pred, target)
        return unpatchify(mixed, cfg.patch_size, cfg.grid_size,
                          cfg.in_channels), mask


def mae_loss(pred: torch.Tensor, images: torch.Tensor, mask: torch.Tensor,
             patch_size: int, norm_pix: bool = True) -> torch.Tensor:
    """Masked-patch MSE, the mean over the removed patches; with
    ``norm_pix`` each target patch is standardised by its mean and its
    population variance (``jnp.var``) + 1e-6."""
    target = patchify(images.float(), patch_size)
    if norm_pix:
        mean = target.mean(-1, keepdim=True)
        var = target.var(-1, keepdim=True, correction=0)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    per_patch = ((pred - target) ** 2).mean(-1)
    return (per_patch * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@torch.no_grad()
def load_encoder_into_vit(mae_params: "dict[str, torch.Tensor]",
                          vit_params: "dict[str, torch.Tensor]"
                          ) -> "dict[str, torch.Tensor]":
    """A ``ViTClassifier`` state dict initialised from an MAE's
    (``vit_tpu/models/mae.py:load_encoder_into_vit``): the patch projection,
    the transformer stack and the cls token (into ``extra_emb`` row 0) come
    from the encoder; ``pos_emb`` and the head keep the classifier's own
    values. Returns a new dict of copies; the inputs are untouched."""
    new = {k: v.clone() for k, v in vit_params.items()}
    for key, value in mae_params.items():
        for part in ("patch_proj.", "transformer."):
            if key.startswith("encoder." + part):
                target = "vit." + key.removeprefix("encoder.")
                if target not in new:
                    raise KeyError(f"the classifier has no {target!r} for "
                                   f"the MAE's {key!r}")
                new[target] = value.detach().clone().to(new[target].dtype)
    if "vit.extra_emb" in new:
        new["vit.extra_emb"][0] = mae_params["encoder.cls_token"][0]
    return new
