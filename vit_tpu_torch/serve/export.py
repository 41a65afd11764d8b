"""Export and loading for serving (counterpart of
``vit_tpu/serve/export.py``).

Three exports, each with the JAX export's arguments and manifest:

  ``export_tokenizer`` (titok, vit_vqgan, enhancing, tatitok,
  llamagen_titok): ``encode`` images (B, H, W, 3) float32 → code indices
  (B, N) int32 (llamagen_titok: frozen-VQ code ids (B, vq_latent_tokens)
  → indices) and ``decode`` indices → images (llamagen_titok: logits over
  the VQ codebook);
  ``export_classifier``: ``predict`` images → logits (B, num_classes);
  ``export_videogpt``: ``generate`` conditioning codes (B, C) int32 → the
  rollout (B, C + N) int32.

Each takes its weights in one of two forms, told apart by the first
argument: a checkpoint directory (a ``str`` or path: ``<tag>_config.json``
read by ``utils/config.py:dataclass_from_dict``, the parameters by
``train/checkpoint.py:load_params``, the EMA average under ``use_ema``)
or a live model (an ``nn.Module``: its own config and weights, ``tag`` and
``step`` null). ``quantize="int8"`` writes the int8 twin
(``core/quant.py:quantize_params``; not for enhancing), and for a tokenizer
``_quant_fidelity`` records the JAX manifest's fidelity fields from a probe
drawn from a seeded ``torch.Generator`` (JAX's ``jax.random`` probe cannot be
reproduced here). ``dp`` > 1 is refused (ROADMAP Queue A #9), as is a
text-guided TATiTok.

``weights.npz`` is in the JAX export's layout (the flax param tree under
"/"-joined keys, int8 sites as ``kernel_q``/``scale``/``bias``, through
``vit_tpu_torch.bridge``), and ``manifest.json`` carries the JAX fields plus
``"config"`` (the model config the weights belong to) and
``"torch_version"``. PyTorch runs eagerly, so there is no serialized
executable: ``load_exported`` dispatches on the manifest's ``"model"``,
rebuilds the model from the config on ``device`` and returns closures that
take numpy arrays (or tensors) and return tensors on that device. The
port's attention is always its kernels; ``platforms`` and ``attn_impl``
are recorded as given.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path

import numpy as np
import torch
from torch import nn

from vit_tpu_torch.bridge import (flatten, flax_from_state_dict, flax_tree,
                                  module_state_dict_from_flax, unflatten)
from vit_tpu_torch.core.quant import quantize_params
from vit_tpu_torch.models.enhancing_vqgan import (EnhancingViTVQGAN,
                                                  EnhancingVQGANConfig)
from vit_tpu_torch.models.llamagen_titok import (LlamaGenTiTok,
                                                 LlamaGenTiTokConfig)
from vit_tpu_torch.models.tatitok import TATiTok, TATiTokConfig
from vit_tpu_torch.models.titok import TiTok, TiTokConfig
from vit_tpu_torch.models.videogpt import VideoGPT, VideoGPTConfig, generate
from vit_tpu_torch.models.vit import ViTClassifier, ViTConfig
from vit_tpu_torch.models.vit_vqgan import ViTVQGAN, ViTVQGANConfig
from vit_tpu_torch.train.checkpoint import _config_to_dict, has_ema, load_params
from vit_tpu_torch.utils.config import dataclass_from_dict

# model name → (config class, model class)
FAMILIES = {
    "titok": (TiTokConfig, TiTok),
    "vit_vqgan": (ViTVQGANConfig, ViTVQGAN),
    "enhancing": (EnhancingVQGANConfig, EnhancingViTVQGAN),
    "tatitok": (TATiTokConfig, TATiTok),
    "llamagen_titok": (LlamaGenTiTokConfig, LlamaGenTiTok),
    "vit_classifier": (ViTConfig, ViTClassifier),
    "videogpt": (VideoGPTConfig, VideoGPT),
}
TOKENIZERS = ("titok", "vit_vqgan", "enhancing", "tatitok", "llamagen_titok")
PLATFORMS = ("cpu", "cuda")


def _check_quantize(quantize, model: str = "") -> None:
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode: {quantize!r} "
                         "(None or 'int8')")
    if quantize and model == "enhancing":
        raise ValueError(
            "quantize is not supported for the 'enhancing' model: it uses "
            "its own PreNorm/Tanh-FFN transformer stack (reference "
            "train_enhancing_vitvqgan.py:104-169), not the shared core the "
            "int8 path hooks into")


def _check_dp(dp: int) -> None:
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    if dp > 1:
        raise NotImplementedError(
            f"dp={dp}: data-parallel serving over several GPUs is not "
            "ported; the port serves on one GPU (ROADMAP Queue A #9, "
            "multi-GPU)")


def _build(name: str, cfg, device, num_classes: "int | None" = None):
    cls = FAMILIES[name][1]
    if name == "vit_classifier":
        return cls(cfg, num_classes, device=device)
    return cls(cfg, device=device)


def _family(model: nn.Module) -> str:
    for name, (_, cls) in FAMILIES.items():
        if type(model) is cls:
            return name
    raise ValueError(f"unsupported model for export: {type(model).__name__}")


def _source(source, name: str, tag: str, use_ema: bool, device):
    """(fp model, its config, checkpoint tag, step) from a checkpoint
    directory (the model built on ``device``, in eval mode) or a live model
    (as it is)."""
    if isinstance(source, nn.Module):
        if _family(source) != name:
            raise ValueError(f"a {type(source).__name__} is not a {name!r} "
                             "model")
        return source, source.config, None, None
    ckpt_dir = str(source)
    if use_ema and not has_ema(ckpt_dir, tag):
        raise ValueError(
            f"use_ema: checkpoint {ckpt_dir}/{tag} holds no EMA average "
            "(train with --ema_decay to write one)")
    cfg = dataclass_from_dict(FAMILIES[name][0], json.loads(
        (Path(ckpt_dir) / f"{tag}_config.json").read_text()))
    params = load_params(ckpt_dir, tag, ema=use_ema)
    meta = Path(ckpt_dir) / f"{tag}_meta.json"
    step = json.loads(meta.read_text()).get("step") if meta.exists() else None
    num_classes = (params["head.weight"].shape[0]
                   if name == "vit_classifier" else None)
    model = _build(name, cfg, device, num_classes)
    model.load_state_dict(params)
    return model.eval().requires_grad_(False), cfg, tag, step


def _quantized(model: nn.Module, name: str, quantize: str) -> nn.Module:
    """The int8 twin of ``model`` on its device, its dense sites filled
    by ``quantize_params`` from ``model``'s weights (quantized there)."""
    cfg = dataclasses.replace(model.config, quant=quantize)
    num_classes = (model.head.out_features if name == "vit_classifier"
                   else None)
    target = flax_tree(_build(name, cfg, "meta", num_classes).state_dict())
    params = quantize_params(target, flax_tree(model.state_dict()))
    device = next(model.parameters()).device
    twin = _build(name, cfg, device, num_classes)
    twin.load_state_dict(module_state_dict_from_flax(params, twin))
    return twin.eval().requires_grad_(False)


def _codec(model: nn.Module, name: str):
    """(encode, decode) of a tokenizer (``_make_codec``, :179-199)."""
    if name == "tatitok":
        return (lambda x: model.encode(x)[1]["min_encoding_indices"],
                model.decode_tokens)
    return model.encode, model.decode_indices


@torch.inference_mode()
def _quant_fidelity(name: str, cfg, model_fp, model_q) -> dict:
    """The int8 twin against the fp model on a probe batch of two
    (``_quant_fidelity``, :202-239): the encode-index agreement, and the
    decode PSNR against the fp reconstruction (images) or the argmax
    agreement of the code logits (llamagen_titok), both decodes from the
    fp indices. The probe comes from ``torch.Generator().manual_seed(0)``."""
    device = next(model_fp.parameters()).device
    gen = torch.Generator().manual_seed(0)
    if name == "llamagen_titok":
        probe = torch.randint(0, cfg.vq_codebook_size,
                              (2, cfg.vq_latent_tokens), generator=gen,
                              dtype=torch.int32)
    else:
        probe = torch.rand((2, cfg.image_size, cfg.image_size, 3),
                           generator=gen)
    (enc_fp, dec_fp), (enc_q, dec_q) = (_codec(model_fp, name),
                                        _codec(model_q, name))
    probe = probe.to(device)
    idx_fp, idx_q = enc_fp(probe), enc_q(probe)
    out = {"quant_encode_index_agreement":
           round(float((idx_fp == idx_q).float().mean()), 4)}
    o_fp, o_q = dec_fp(idx_fp).float(), dec_q(idx_fp).float()
    if name == "llamagen_titok":
        out["quant_decode_logit_argmax_agreement"] = round(float(
            (o_fp.argmax(-1) == o_q.argmax(-1)).float().mean()), 4)
    else:
        mse = float(((o_fp - o_q) ** 2).mean())
        out["quant_decode_psnr_db_vs_fp"] = (
            round(10.0 * np.log10(1.0 / mse), 2) if mse > 0 else float("inf"))
    return out


def _write(out_dir: str, model: nn.Module, functions, manifest: dict) -> Path:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "weights.npz",
             **flatten(flax_from_state_dict(model.state_dict())))
    manifest = dict(manifest, torch_version=torch.__version__,
                    functions=sorted(functions),
                    config=_config_to_dict(model.config))
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return out


def export_tokenizer(source, out_dir: str, *, model: str = "titok",
                     bs: int = 1, tag: str = "best", platforms=PLATFORMS,
                     attn_impl: str = "pallas",
                     quantize: "str | None" = None, dp: int = 1,
                     use_ema: bool = False, device="cuda") -> Path:
    """Write a tokenizer's encode/decode export to ``out_dir``. ``source``
    is a checkpoint directory of the ``model`` family (built on
    ``device``) or a live tokenizer (its family and device are its own).
    ``bs`` is the batch the server pads requests to (0: any batch, as it
    comes). ``quantize="int8"`` exports the int8 twin and records its
    fidelity against the fp model in the manifest."""
    if isinstance(source, nn.Module):
        model = _family(source)
    if model not in TOKENIZERS:
        raise ValueError(f"unsupported model for export: {model}")
    _check_quantize(quantize, model)
    _check_dp(dp)
    net, cfg, tag, step = _source(source, model, tag, use_ema, device)
    if model == "tatitok" and cfg.text_guidance:
        raise ValueError(
            "text-guided TATiTok export is not supported: decode needs a "
            "(B, ctx, text_dim) guidance tensor per request")
    fidelity = {}
    if quantize:
        net_q = _quantized(net, model, quantize)
        fidelity = _quant_fidelity(model, cfg, net, net_q)
        net = net_q
    if model == "llamagen_titok":
        input_desc = {"input": "vq_code_ids",
                      "input_shape": [bs, cfg.vq_latent_tokens],
                      "output": "vq_code_logits"}
    else:
        input_desc = {"input": "images", "image_size": cfg.image_size}
    return _write(out_dir, net, ("encode", "decode"), {
        "model": model, "bs": bs, "tag": tag, **input_desc,
        "n_tokens": cfg.n_patches if model == "vit_vqgan"
        else cfg.latent_tokens,
        "codebook_size": cfg.codebook_size, "indices_dtype": "int32",
        "platforms": list(platforms), "attn_impl": attn_impl, "step": step,
        "quantize": quantize, "dp": dp, "use_ema": use_ema, **fidelity,
    })


def export_classifier(source, out_dir: str, *, bs: int = 1,
                      tag: str = "best", platforms=PLATFORMS,
                      attn_impl: str = "pallas",
                      num_classes: "int | None" = None,
                      quantize: "str | None" = None, dp: int = 1,
                      use_ema: bool = False, device="cuda") -> Path:
    """Write a ViT classifier's ``predict`` (images → logits) export.
    ``num_classes`` is read off the head's weight when not given (and must
    match it when given)."""
    _check_quantize(quantize)
    _check_dp(dp)
    net, cfg, tag, step = _source(source, "vit_classifier", tag, use_ema,
                                  device)
    head = net.head.out_features
    if num_classes is not None and num_classes != head:
        raise ValueError(f"num_classes {num_classes}, but the head has "
                         f"{head} outputs")
    if quantize:
        net = _quantized(net, "vit_classifier", quantize)
    return _write(out_dir, net, ("predict",), {
        "model": "vit_classifier", "bs": bs, "tag": tag,
        "image_size": cfg.image_size, "num_classes": head,
        "platforms": list(platforms), "attn_impl": attn_impl, "step": step,
        "quantize": quantize, "dp": dp, "use_ema": use_ema,
    })


def export_videogpt(source, out_dir: str, *, cond_frames: int = 8,
                    gen_frames: int = 8, bs: int = 1, tag: str = "best",
                    platforms=PLATFORMS, attn_impl: str = "pallas",
                    temperature: float = 0.0, top_k: "int | None" = None,
                    quantize: "str | None" = None, dp: int = 1,
                    use_ema: bool = False, device="cuda") -> Path:
    """Write the AR prior's rollout ``generate``: conditioning codes (B,
    cond_frames·frame_size) int32 → the full rollout (B, (cond_frames +
    gen_frames)·frame_size) int32, with the frame counts and the decoding
    baked in. Greedy by default; with ``temperature`` > 0 the call also
    takes a seed, which the single-array HTTP server cannot send (call
    ``load_exported``'s closure directly)."""
    _check_quantize(quantize)
    _check_dp(dp)
    net, cfg, tag, step = _source(source, "videogpt", tag, use_ema, device)
    cond = cond_frames * cfg.frame_size
    n = gen_frames * cfg.frame_size
    if cond + n > cfg.max_tokens:
        raise ValueError(f"cond+gen = {cond + n} tokens exceeds the model's "
                         f"max_tokens {cfg.max_tokens}")
    if quantize:
        net = _quantized(net, "videogpt", quantize)
    return _write(out_dir, net, ("generate",), {
        "model": "videogpt", "bs": bs, "tag": tag,
        "input": "code_ids", "input_shape": [bs, cond],
        "frame_size": cfg.frame_size, "codebook_size": cfg.codebook_size,
        "cond_frames": cond_frames, "gen_frames": gen_frames,
        "temperature": temperature, "top_k": top_k,
        "platforms": list(platforms), "attn_impl": attn_impl, "step": step,
        "quantize": quantize, "dp": dp, "use_ema": use_ema,
    })


def load_exported(out_dir: str, device: "str | torch.device") -> dict:
    """Load an export dir → its closures, "manifest" and "_in_avals" (the
    data arguments' shapes and dtypes, None for any batch).

    Tokenizers: ``encode`` and ``decode`` as ``export_tokenizer`` lists
    them; the classifier: ``predict``; VideoGPT: ``generate`` codes (B,
    cond) int32 [, seed when sampled] → (B, cond + n) int32. Calls are
    serialized by one lock, so concurrent requests never interleave on the
    device."""
    out = Path(out_dir)
    manifest = json.loads((out / "manifest.json").read_text())
    if "config" not in manifest:
        raise ValueError(f"{out / 'manifest.json'} has no 'config': not a "
                         "vit_tpu_torch export")
    name = manifest["model"]
    if name not in FAMILIES:
        raise ValueError(f"unsupported model in {out}: {name!r}")
    cfg = dataclass_from_dict(FAMILIES[name][0], manifest["config"])
    model = _build(name, cfg, device, manifest.get("num_classes"))
    with np.load(out / "weights.npz") as npz:
        params = unflatten({k: npz[k] for k in npz.files})
    model.load_state_dict(module_state_dict_from_flax(params, model))
    model = model.eval().requires_grad_(False)
    bs = int(manifest["bs"]) or None
    if name == "videogpt":
        return _load_videogpt(manifest, model, device, bs)
    lock = threading.Lock()

    def make_call(method):
        def call(x):
            if not torch.is_tensor(x):
                x = torch.from_numpy(np.ascontiguousarray(x))
            with lock, torch.inference_mode():
                return method(x.to(device))
        return call

    if name == "vit_classifier":
        size = cfg.image_size
        return {"predict": make_call(model), "manifest": manifest,
                "_in_avals": {"predict": [(
                    (bs, size, size, cfg.in_channels), "float32")]}}
    encode, decode = _codec(model, name)
    if name == "llamagen_titok":
        enc_aval = ((bs, cfg.vq_latent_tokens), "int32")
    else:
        enc_aval = ((bs, cfg.image_size, cfg.image_size, 3), "float32")
    return {
        "encode": make_call(encode),
        "decode": make_call(decode),
        "manifest": manifest,
        # data-arg avals, as the JAX loader gives them (None: any batch)
        "_in_avals": {"encode": [enc_aval],
                      "decode": [((bs, manifest["n_tokens"]),
                                  manifest["indices_dtype"])]},
    }


def _load_videogpt(manifest: dict, model: VideoGPT, device, bs) -> dict:
    lock = threading.Lock()
    cond = manifest["cond_frames"] * model.config.frame_size
    n = manifest["gen_frames"] * model.config.frame_size
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
