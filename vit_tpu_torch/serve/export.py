"""Export and loading for serving (counterpart of
``vit_tpu/serve/export.py:279-296, 395-402, 462-608``).

``export_tokenizer`` (TiTok) and ``export_videogpt`` (the AR prior's
rollout) write ``weights.npz`` in the JAX export's layout (the flax param
tree under "/"-joined keys, through ``vit_tpu_torch.bridge``) and a
``manifest.json`` with the JAX export's fields plus ``"config"``, the model
config the weights belong to. PyTorch runs eagerly, so there is no
serialized executable: ``load_exported`` dispatches on the manifest's
``"model"``, rebuilds the model from the config, loads the weights onto
``device`` and returns closures that take numpy arrays (or tensors) and
return tensors on that device.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import torch

from vit_tpu_torch.bridge import (flatten, flax_from_state_dict,
                                  state_dict_from_flax, unflatten,
                                  videogpt_state_dict_from_flax)
from vit_tpu_torch.models.titok import TiTok, TiTokConfig
from vit_tpu_torch.models.videogpt import VideoGPT, VideoGPTConfig, generate

_CONFIG_FIELDS = {
    TiTokConfig: ("image_size", "patch_size", "latent_tokens",
                  "codebook_size", "latent_dim", "transformer", "dtype",
                  "param_dtype"),
    VideoGPTConfig: ("frame_size", "codebook_size", "transformer",
                     "max_frames", "dropout", "dtype", "param_dtype"),
}


def _config_to_json(cfg) -> dict:
    out = {f: getattr(cfg, f) for f in _CONFIG_FIELDS[type(cfg)]}
    out["dtype"] = str(cfg.dtype).removeprefix("torch.")
    out["param_dtype"] = str(cfg.param_dtype).removeprefix("torch.")
    return out


def _config_from_json(cls, d: dict):
    kw = {f: d[f] for f in _CONFIG_FIELDS[cls]}
    kw["dtype"] = getattr(torch, d["dtype"])
    kw["param_dtype"] = getattr(torch, d["param_dtype"])
    return cls(**kw)


def _write(out_dir: str, model, manifest: dict) -> Path:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "weights.npz",
             **flatten(flax_from_state_dict(model.state_dict())))
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return out


def export_tokenizer(model: TiTok, out_dir: str, *, bs: int = 1) -> Path:
    """Write ``model``'s weights and manifest to ``out_dir``. ``bs`` is the
    batch the server pads requests to (0: any batch, as it comes). The
    manifest's ``tag`` and ``step`` are null: the weights come from a live
    model, not a checkpoint."""
    cfg = model.config
    return _write(out_dir, model, {
        "model": "titok", "bs": bs, "tag": None, "input": "images",
        "image_size": cfg.image_size, "n_tokens": cfg.latent_tokens,
        "codebook_size": cfg.codebook_size, "indices_dtype": "int32",
        "platforms": ["cpu", "cuda"], "attn_impl": "packed", "step": None,
        "quantize": None, "dp": 1, "use_ema": False,
        "torch_version": torch.__version__,
        "functions": ["decode", "encode"],
        "config": _config_to_json(cfg),
    })


def export_videogpt(model: VideoGPT, out_dir: str, *, cond_frames: int = 8,
                    gen_frames: int = 8, bs: int = 1, temperature: float = 0.0,
                    top_k: "int | None" = None) -> Path:
    """Write ``model``'s weights and a manifest for the rollout
    ``generate``: conditioning codes (B, cond_frames·frame_size) int32 →
    the full rollout (B, (cond_frames + gen_frames)·frame_size) int32, with
    the frame counts and the decoding baked in. Greedy by default; with
    ``temperature`` > 0 the call also takes a seed, which the single-array
    HTTP server cannot send (call ``load_exported``'s closure directly)."""
    cfg = model.config
    cond = cond_frames * cfg.frame_size
    n = gen_frames * cfg.frame_size
    if cond + n > cfg.max_tokens:
        raise ValueError(f"cond+gen = {cond + n} tokens exceeds the model's "
                         f"max_tokens {cfg.max_tokens}")
    return _write(out_dir, model, {
        "model": "videogpt", "bs": bs, "tag": None,
        "input": "code_ids", "input_shape": [bs, cond],
        "frame_size": cfg.frame_size, "codebook_size": cfg.codebook_size,
        "cond_frames": cond_frames, "gen_frames": gen_frames,
        "temperature": temperature, "top_k": top_k,
        "platforms": ["cpu", "cuda"], "attn_impl": "unpacked", "step": None,
        "quantize": None, "dp": 1, "use_ema": False,
        "torch_version": torch.__version__, "functions": ["generate"],
        "config": _config_to_json(cfg),
    })


def load_exported(out_dir: str, device: "str | torch.device") -> dict:
    """Load an export dir → its closures, "manifest" and "_in_avals" (the
    data arguments' shapes and dtypes, None for any batch).

    TiTok: ``encode`` images (B, H, W, 3) float32 → indices (B, K) int32,
    ``decode`` indices (B, K) int32 → images (B, H, W, 3) float32. VideoGPT:
    ``generate`` codes (B, cond) int32 [, seed when sampled] → (B, cond + n)
    int32. Calls are serialized by one lock, so concurrent requests never
    interleave on the device."""
    out = Path(out_dir)
    manifest = json.loads((out / "manifest.json").read_text())
    if "config" not in manifest:
        raise ValueError(f"{out / 'manifest.json'} has no 'config': not a "
                         "vit_tpu_torch export")
    with np.load(out / "weights.npz") as npz:
        params = unflatten({k: npz[k] for k in npz.files})
    bs = int(manifest["bs"]) or None
    if manifest["model"] == "videogpt":
        return _load_videogpt(manifest, params, device, bs)
    cfg = _config_from_json(TiTokConfig, manifest["config"])
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

    size = cfg.image_size
    return {
        "encode": make_call(model.encode),
        "decode": make_call(model.decode_indices),
        "manifest": manifest,
        # data-arg avals, as the JAX loader gives them (None: any batch)
        "_in_avals": {"encode": [((bs, size, size, 3), "float32")],
                      "decode": [((bs, cfg.latent_tokens), "int32")]},
    }


def _load_videogpt(manifest: dict, params: dict, device, bs) -> dict:
    cfg = _config_from_json(VideoGPTConfig, manifest["config"])
    model = VideoGPT(cfg, device="meta")
    model.load_state_dict(videogpt_state_dict_from_flax(params, cfg),
                          assign=True)
    model = model.to(device).eval().requires_grad_(False)
    lock = threading.Lock()
    cond = manifest["cond_frames"] * cfg.frame_size
    n = manifest["gen_frames"] * cfg.frame_size
    temperature, top_k = manifest["temperature"], manifest["top_k"]
    avals = [((bs, cond), "int32")]

    def call(tokens, seed=None):
        if not torch.is_tensor(tokens):
            tokens = torch.from_numpy(np.ascontiguousarray(tokens))
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=device).manual_seed(int(seed))
        with lock:
            return generate(model, tokens.to(device), n,
                            temperature=temperature, top_k=top_k,
                            generator=gen)

    if temperature > 0.0:
        avals.append(((), "uint32"))
    return {"generate": call, "manifest": manifest,
            "_in_avals": {"generate": avals}}
