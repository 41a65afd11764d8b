"""The frozen tokenizer interface VideoGPT trains on (counterpart of
``vit_tpu/models/pretrained.py:147-180``, the TiTok branch).

The JAX class pairs a flax module with its params; here the port's ``TiTok``
holds its own weights, so the wrapper takes the module alone and freezes it
(eval mode, no gradients). The Bytedance TATiTok tokenizer is not ported.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.models.titok import TiTok


class FrozenTokenizer:
    """Image batch → code indices and back (reference train_videogpt.py:
    124-127, 146-158)."""

    def __init__(self, model: TiTok):
        if not isinstance(model, TiTok):
            raise NotImplementedError(
                f"FrozenTokenizer takes the port's TiTok, got "
                f"{type(model).__name__}; the TATiTok tokenizer is not ported")
        self.model = model.eval().requires_grad_(False)

    @torch.no_grad()
    def encode_indices(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) in [0, 1] → (N, K) int32 codes."""
        return self.model.encode(frames)

    @torch.no_grad()
    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(N, K) codes → (N, H, W, 3) images."""
        return self.model.decode_indices(indices)
