"""Puzzle, masked position prediction pretraining (counterpart of
``vit_tpu/models/puzzle.py``; MP3, arXiv 2207.07611).

Every patch brings its content embedding, but only a random (1 −
mask_ratio) share of them also gets its position embedding: the same
argsort masking as MAE, applied by multiplying the learned ``pos_emb`` by
(1 − mask) token by token, so the whole sequence is encoded (no gathers).
An fp32 head classifies, for each token, which of the ``n_patches`` grid
positions it came from; the loss scores the position-less tokens only.
As ``models/mae.py``, ``forward`` takes the noise or draws it from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vit_tpu_torch.core.config import TransformerConfig, transformer_configs
from vit_tpu_torch.core.transformer import Transformer, linear
from vit_tpu_torch.models.mae import random_masking
from vit_tpu_torch.models.vit import PatchEmbed


@dataclasses.dataclass(eq=False)
class PuzzleConfig:
    """``mask_ratio`` is the share of patches stripped of their position
    embedding (the prediction targets); the encoder follows the S/B/L
    presets."""

    image_size: int
    in_channels: int = 3
    patch_size: int = 16
    transformer: str = "B"
    mask_ratio: float = 0.75
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.n_patches = (self.image_size // self.patch_size) ** 2
        self.len_keep = max(1, int(round(self.n_patches
                                         * (1.0 - self.mask_ratio))))
        self.trans_config: TransformerConfig = transformer_configs[
            self.transformer](block_size=self.n_patches, dropout=self.dropout,
                              dtype=self.dtype, param_dtype=self.param_dtype)


class Puzzle(nn.Module):
    """``forward(images, noise=None, generator=None) → (logits, mask)``:
    ``logits`` (B, n_patches, n_patches) fp32, each token's position
    classification, and ``mask`` (B, n_patches), 1 on the tokens without
    a position (the scored ones)."""

    def __init__(self, config: PuzzleConfig, device=None):
        super().__init__()
        self.config = config
        tc = config.trans_config
        self.patch_proj = PatchEmbed(config.patch_size, tc.n_embd,
                                     config.in_channels, dtype=tc.dtype,
                                     param_dtype=tc.param_dtype, device=device)
        self.pos_emb = nn.Parameter(torch.empty(
            config.n_patches, tc.n_embd, dtype=tc.param_dtype, device=device))
        self.transformer = Transformer(tc, device=device)
        self.head = nn.Linear(tc.n_embd, config.n_patches,
                              dtype=tc.param_dtype, device=device)

    def forward(self, images: torch.Tensor,
                noise: "torch.Tensor | None" = None,
                generator: "torch.Generator | None" = None):
        cfg = self.config
        dt = cfg.trans_config.dtype
        x = self.patch_proj(images)
        if noise is None:
            noise = torch.rand(images.shape[0], cfg.n_patches,
                               generator=generator, device=images.device)
        _, _, mask = random_masking(noise.to(images.device), cfg.len_keep)
        x = x + self.pos_emb.to(dt)[None] * (1.0 - mask)[:, :, None].to(dt)
        x = self.transformer(x, generator=generator)
        return linear(x.float(), self.head, torch.float32), mask


def puzzle_loss(logits: torch.Tensor, mask: torch.Tensor):
    """Masked-token position cross-entropy and accuracy
    (``vit_tpu/models/puzzle.py:puzzle_loss``): token i's target is its own
    grid index i. The cross-entropy is logsumexp − the target's logit; the
    accuracy's argmax takes the first index on ties, as ``jnp.argmax``."""
    b, n = logits.shape[:2]
    targets = torch.arange(n, device=logits.device)[None].expand(b, n)
    ce = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, targets[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (ce * mask).sum() / denom
    acc = ((logits.argmax(-1) == targets).float() * mask).sum() / denom
    return loss, acc


@torch.no_grad()
def load_puzzle_into_vit(puzzle_params: "dict[str, torch.Tensor]",
                         vit_params: "dict[str, torch.Tensor]"
                         ) -> "dict[str, torch.Tensor]":
    """A ``ViTClassifier`` state dict initialised from a Puzzle's
    (``vit_tpu/models/puzzle.py:load_puzzle_into_vit``): the patch
    projection, the learned ``pos_emb`` and the transformer stack transfer;
    the extra-token embeddings and the head keep the classifier's own
    values. Returns a new dict of copies; the inputs are untouched."""
    new = {k: v.clone() for k, v in vit_params.items()}
    for key, value in puzzle_params.items():
        if key.startswith(("patch_proj.", "transformer.")) or key == "pos_emb":
            target = "vit." + key
            if target not in new:
                raise KeyError(f"the classifier has no {target!r} for the "
                               f"Puzzle's {key!r}")
            new[target] = value.detach().clone().to(new[target].dtype)
    return new
