"""Carry weights between the JAX package's param tree and the port's state dict.

The port names its modules after the flax modules, so one rule maps a flax
leaf path to a state-dict key:

  - path segments join with "." and ``layer_{i}`` becomes ``layers.{i}``;
  - a Dense ``kernel`` (in, out) becomes ``weight`` (out, in);
  - a Conv ``kernel`` HWIO becomes ``weight`` OIHW; a depthwise kernel
    (7, 7, 1, C) thereby becomes (C, 1, 7, 7);
  - a LayerNorm ``scale`` becomes ``weight`` (the Bytedance block's affine
    ``ln1``/``ln2`` and flax ``nn.LayerNorm``'s alike);
  - ``bias``, ``pos_emb``, ``extra_emb``, ``codebook``, ``gamma``,
    VideoGPT's raw 2-D ``tok_embed`` and ``pos_embed``, MAE's
    ``cls_token`` and ``mask_token``, and TATiTok's ``latent_tokens``,
    class, mask and positional tables and ``quantize/embedding`` keep their
    name and layout (they are no ``kernel``, so nothing transposes them).
    The
    split-bias ``attn/qkv`` tree (``_ProjParams``) has the same
    ``{kernel, bias}`` keys as a Dense.

The way back tells a Dense or Conv ``weight`` from a LayerNorm ``weight`` by
its rank (a LayerNorm's is 1-D).

``flatten``/``unflatten`` convert between the nested dict and the
"/"-joined keys of ``weights.npz`` (the layout of the JAX export's
``_write_artifacts``). Only the unrolled ``layer_{i}`` stack is read; the
scanned ``layers/...`` layout is not.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def flatten(tree: dict, prefix: str = "") -> "dict[str, np.ndarray]":
    """Nested dict of arrays → {"a/b/c": array}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten(flat: dict) -> dict:
    """{"a/b/c": array} → nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _to_torch(leaf: np.ndarray) -> np.ndarray:
    """A flax ``kernel`` in the port's ``weight`` layout."""
    return leaf.T if leaf.ndim == 2 else leaf.transpose(3, 2, 0, 1)


def _to_flax(arr: np.ndarray) -> np.ndarray:
    """Inverse of ``_to_torch``."""
    return arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)


def _torch_key(flax_key: str) -> "tuple[str, bool]":
    """"enc/vit/transformer/layer_0/attn/qkv/kernel" →
    ("enc.vit.transformer.layers.0.attn.qkv.weight", is_kernel=True)."""
    key = re.sub(r"\blayer_(\d+)\b", r"layers.\1", flax_key.replace("/", "."))
    if key.endswith(".kernel"):
        return key.removesuffix(".kernel") + ".weight", True
    if key.endswith(".scale"):
        return key.removesuffix(".scale") + ".weight", False
    return key, False


def _flax_key(torch_key: str, ndim: int) -> "tuple[str, bool]":
    """Inverse of ``_torch_key`` for a tensor of rank ``ndim``."""
    key = re.sub(r"\blayers\.(\d+)\b", r"layer_\1", torch_key).replace(".", "/")
    if key.endswith("/weight"):
        if ndim == 1:
            return key.removesuffix("/weight") + "/scale", False
        return key.removesuffix("/weight") + "/kernel", True
    return key, False


def _from_flax(params: dict, expected: dict) -> "dict[str, torch.Tensor]":
    """Nested flax params → a state dict with ``expected``'s keys and
    shapes. Raises unless every JAX leaf lands on exactly one port parameter
    of the right shape and every port parameter is filled."""
    out: "dict[str, torch.Tensor]" = {}
    for flax_key, leaf in flatten(params).items():
        key, is_kernel = _torch_key(flax_key)
        if key not in expected:
            raise KeyError(f"JAX leaf {flax_key!r} has no port parameter "
                           f"({key!r})")
        if key in out:
            raise KeyError(f"port parameter {key!r} filled twice")
        arr = np.array(_to_torch(leaf) if is_kernel else leaf,
                       order="C")  # owned copy
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"{flax_key}: shape {arr.shape} does not fit "
                             f"{key} {tuple(expected[key].shape)}")
        out[key] = torch.from_numpy(arr)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing}")
    return out


def state_dict_from_flax(params: dict, cfg) -> "dict[str, torch.Tensor]":
    """JAX TiTok params (nested dict of arrays) → the port's state dict for a
    ``TiTok(cfg)``, with the checks of ``_from_flax``."""
    from vit_tpu_torch.models.titok import TiTok

    return _from_flax(params, TiTok(cfg, device="meta").state_dict())


def videogpt_state_dict_from_flax(params: dict, cfg) -> "dict[str, torch.Tensor]":
    """JAX VideoGPT params → the port's state dict for a ``VideoGPT(cfg)``,
    with the checks of ``_from_flax``."""
    from vit_tpu_torch.models.videogpt import VideoGPT

    return _from_flax(params, VideoGPT(cfg, device="meta").state_dict())


def classifier_state_dict_from_flax(params: dict, cfg, num_classes: int
                                    ) -> "dict[str, torch.Tensor]":
    """JAX ViTClassifier params (the ``{"vit": …, "head": …}`` tree) → the
    port's state dict for a ``ViTClassifier(cfg, num_classes)``, with the
    checks of ``_from_flax``."""
    from vit_tpu_torch.models.vit import ViTClassifier

    return _from_flax(params, ViTClassifier(cfg, num_classes,
                                            device="meta").state_dict())


def mae_state_dict_from_flax(params: dict, cfg) -> "dict[str, torch.Tensor]":
    """JAX MAE params (the ``{"encoder": …, "decoder": …}`` tree: the
    encoder's ``patch_proj``, ``cls_token`` and ``transformer``, the
    decoder's ``embed``, ``mask_token``, ``transformer`` and ``pred``) → the
    port's state dict for an ``MAE(cfg)``, with the checks of
    ``_from_flax``."""
    from vit_tpu_torch.models.mae import MAE

    return _from_flax(params, MAE(cfg, device="meta").state_dict())


def puzzle_state_dict_from_flax(params: dict, cfg
                                ) -> "dict[str, torch.Tensor]":
    """JAX Puzzle params (``patch_proj``, ``pos_emb``, ``transformer`` and
    the position ``head``) → the port's state dict for a ``Puzzle(cfg)``,
    with the checks of ``_from_flax``."""
    from vit_tpu_torch.models.puzzle import Puzzle

    return _from_flax(params, Puzzle(cfg, device="meta").state_dict())


def tatitok_state_dict_from_flax(params: dict, cfg
                                 ) -> "dict[str, torch.Tensor]":
    """JAX TATiTok params (``latent_tokens``, ``encoder``, ``decoder`` and
    ``quantize/embedding``; the transformers as TiTok's, with the affine
    ``ln1``/``ln2`` and ``attn/out_proj``; the decoder's 3×3 ``conv_out``
    HWIO → OIHW) → the port's state dict for a ``TATiTok(cfg)``, with the
    checks of ``_from_flax``."""
    from vit_tpu_torch.models.tatitok import TATiTok

    return _from_flax(params, TATiTok(cfg, device="meta").state_dict())


def uvit_state_dict_from_flax(params: dict, block
                              ) -> "dict[str, torch.Tensor]":
    """JAX ``UViTBlock`` params → the state dict of the port's ``block``
    (``core/uvit.py``), with the checks of ``_from_flax``."""
    return _from_flax(params, block.state_dict())


def convnext_state_dict_from_flax(params: dict, net) -> "dict[str, torch.Tensor]":
    """JAX ConvNeXt params (``vit_tpu/losses/perceptual.py``'s tree) → the
    state dict of the port's ``ConvNeXt`` ``net``, with the checks of
    ``_from_flax``."""
    return _from_flax(params, net.state_dict())


def flax_from_state_dict(state_dict: dict) -> dict:
    """The port's state dict → the JAX package's nested param dict (numpy)."""
    flat = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        flax_key, is_kernel = _flax_key(key, arr.ndim)
        flat[flax_key] = np.ascontiguousarray(_to_flax(arr) if is_kernel
                                              else arr)
    return unflatten(flat)
