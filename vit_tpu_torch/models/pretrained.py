"""The frozen tokenizer interface VideoGPT trains on (counterpart of
``vit_tpu/models/pretrained.py:147-180``, the TiTok branch), and the loader
of ``--tokenizer_ckpt`` (``train_videogpt.py:91-124``).

The JAX class pairs a flax module with its params; here the port's ``TiTok``
holds its own weights, so the wrapper takes the module alone and freezes it
(eval mode, no gradients). The Bytedance TATiTok tokenizer is not ported.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from vit_tpu_torch.models.titok import TiTok, TiTokConfig

# the "random" tokenizer's weights (train_videogpt.py:104 seeds its init
# with PRNGKey(123))
RANDOM_TOKENIZER_SEED = 123


class FrozenTokenizer:
    """Image batch → code indices and back (reference train_videogpt.py:
    124-127, 146-158)."""

    def __init__(self, model: TiTok):
        if not isinstance(model, TiTok):
            raise NotImplementedError(
                f"FrozenTokenizer takes the port's TiTok, got "
                f"{type(model).__name__}; the TATiTok tokenizer is not ported")
        self.model = model.eval().requires_grad_(False)

    @property
    def latent_tokens(self) -> int:
        return self.model.config.latent_tokens

    @property
    def codebook_size(self) -> int:
        return self.model.config.codebook_size

    @property
    def image_size(self) -> int:
        return self.model.config.image_size

    @torch.no_grad()
    def encode_indices(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) in [0, 1] → (N, K) int32 codes."""
        return self.model.encode(frames)

    @torch.no_grad()
    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """(N, K) codes → (N, H, W, 3) images."""
        return self.model.decode_indices(indices)


def load_tokenizer(spec: str, dtype: torch.dtype, device, *,
                   image_size: int = 64, frame_size: int = 64,
                   codebook_size: int = 1024) -> FrozenTokenizer:
    """``--tokenizer_ckpt`` as ``train_videogpt.py:load_tokenizer`` reads it:

    - ``"random"``: ``TiTokConfig(image_size, 8, frame_size, codebook_size,
      12, "S")`` with weights drawn from ``RANDOM_TOKENIZER_SEED``;
    - a directory the port's ``train_titok`` wrote (``best_config.json`` and
      ``best/state.pt``): that config, computing in ``dtype``, with the
      "best" parameters.

    A Bytedance-format or TATiTok directory (no ``best_config.json``, or
    ``use_l2_norm`` in it), an FSQ tokenizer and, off the CPU, a latent
    width the nearest-code kernel cannot take raise."""
    from vit_tpu_torch.train.checkpoint import load_params
    from vit_tpu_torch.utils.config import dataclass_from_dict
    from vit_tpu_torch.utils.init import init_params_

    if spec == "random":
        model = TiTok(TiTokConfig(image_size, 8, frame_size, codebook_size, 12,
                                  "S", dtype=dtype))
        init_params_(model, torch.Generator().manual_seed(
            RANDOM_TOKENIZER_SEED))
        return FrozenTokenizer(model.to(device))
    cfg_path = Path(spec) / "best_config.json"
    data = json.loads(cfg_path.read_text()) if cfg_path.exists() else None
    if data is None or "use_l2_norm" in data:
        raise NotImplementedError(
            f"--tokenizer_ckpt {spec}: a Bytedance-format or TATiTok "
            "tokenizer is not ported (ROADMAP Queue A #5, the TATiTok "
            "tokenizer)")
    cfg = dataclass_from_dict(TiTokConfig, data)
    if cfg.quantizer == "fsq":
        raise NotImplementedError(
            f"--tokenizer_ckpt {spec}: an FSQ tokenizer's codes range over "
            "prod(fsq_levels), not the prior's codebook_size vocabulary "
            "(ROADMAP Queue C, reference-side hazards)")
    from vit_tpu_torch.kernels.vq import out_of_reach

    if torch.device(device).type != "cpu" and out_of_reach(cfg.latent_dim):
        raise NotImplementedError(f"--tokenizer_ckpt {spec}: "
                                  f"{out_of_reach(cfg.latent_dim)}")
    cfg.dtype = dtype
    cfg.__post_init__()
    model = TiTok(cfg, device="meta")
    model.load_state_dict(load_params(spec, "best"), assign=True)
    return FrozenTokenizer(model.to(device))
