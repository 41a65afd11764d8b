"""Tokenizer export and loading for serving (counterpart of
``vit_tpu/serve/export.py:279-296, 395-402, 538-608``).

``export_tokenizer`` writes ``weights.npz`` in the JAX export's layout (the
flax param tree under "/"-joined keys, through ``vit_tpu_torch.bridge``) and a
``manifest.json`` with the JAX export's fields plus ``"config"``, the
``TiTokConfig`` the weights belong to. PyTorch runs eagerly, so there is no
serialized executable: ``load_exported`` rebuilds the model from the config,
loads the weights onto ``device`` and returns closures that take numpy
arrays (or tensors) and return tensors on that device.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import torch

from vit_tpu_torch.bridge import (flatten, flax_from_state_dict,
                                  state_dict_from_flax, unflatten)
from vit_tpu_torch.models.titok import TiTok, TiTokConfig

_CONFIG_FIELDS = ("image_size", "patch_size", "latent_tokens", "codebook_size",
                  "latent_dim", "transformer", "dtype", "param_dtype")


def _config_to_json(cfg: TiTokConfig) -> dict:
    out = {f: getattr(cfg, f) for f in _CONFIG_FIELDS}
    out["dtype"] = str(cfg.dtype).removeprefix("torch.")
    out["param_dtype"] = str(cfg.param_dtype).removeprefix("torch.")
    return out


def _config_from_json(d: dict) -> TiTokConfig:
    kw = {f: d[f] for f in _CONFIG_FIELDS}
    kw["dtype"] = getattr(torch, d["dtype"])
    kw["param_dtype"] = getattr(torch, d["param_dtype"])
    return TiTokConfig(**kw)


def export_tokenizer(model: TiTok, out_dir: str, *, bs: int = 1) -> Path:
    """Write ``model``'s weights and manifest to ``out_dir``. ``bs`` is the
    batch the server pads requests to (0: any batch, as it comes). The
    manifest's ``tag`` and ``step`` are null: the weights come from a live
    model, not a checkpoint."""
    cfg = model.config
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "weights.npz",
             **flatten(flax_from_state_dict(model.state_dict())))
    manifest = {
        "model": "titok", "bs": bs, "tag": None, "input": "images",
        "image_size": cfg.image_size, "n_tokens": cfg.latent_tokens,
        "codebook_size": cfg.codebook_size, "indices_dtype": "int32",
        "platforms": ["cpu", "cuda"], "attn_impl": "packed", "step": None,
        "quantize": None, "dp": 1, "use_ema": False,
        "torch_version": torch.__version__,
        "functions": ["decode", "encode"],
        "config": _config_to_json(cfg),
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return out


def load_exported(out_dir: str, device: "str | torch.device") -> dict:
    """Load an export dir → {"encode", "decode", "manifest", "_in_avals"}.

    ``encode``: images (B, H, W, 3) float32 → indices (B, K) int32;
    ``decode``: indices (B, K) int32 → images (B, H, W, 3) float32. Calls are
    serialized by one lock, so concurrent requests never interleave on the
    device."""
    out = Path(out_dir)
    manifest = json.loads((out / "manifest.json").read_text())
    if "config" not in manifest:
        raise ValueError(f"{out / 'manifest.json'} has no 'config': not a "
                         "vit_tpu_torch export")
    cfg = _config_from_json(manifest["config"])
    with np.load(out / "weights.npz") as npz:
        params = unflatten({k: npz[k] for k in npz.files})
    model = TiTok(cfg, device="meta")
    model.load_state_dict(state_dict_from_flax(params, cfg), assign=True)
    model = model.to(device).eval().requires_grad_(False)
    lock = threading.Lock()

    def make_call(method):
        def call(x):
            if not torch.is_tensor(x):
                x = torch.from_numpy(np.ascontiguousarray(x))
            with lock, torch.inference_mode():
                return method(x.to(device))
        return call

    bs = int(manifest["bs"]) or None
    size = cfg.image_size
    return {
        "encode": make_call(model.encode),
        "decode": make_call(model.decode_indices),
        "manifest": manifest,
        # data-arg avals, as the JAX loader gives them (None: any batch)
        "_in_avals": {"encode": [((bs, size, size, 3), "float32")],
                      "decode": [((bs, cfg.latent_tokens), "int32")]},
    }
