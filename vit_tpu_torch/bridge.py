"""Carry weights between the JAX package's param tree and the port's state dict.

The port names its modules after the flax modules, so one rule maps a flax
leaf path to a state-dict key:

  - path segments join with "." and ``layer_{i}`` becomes ``layers.{i}``;
  - a Dense ``kernel`` (in, out) becomes ``weight`` (out, in);
  - ``bias``, ``pos_emb``, ``extra_emb`` and ``codebook`` keep their name
    and layout. The split-bias ``attn/qkv`` tree (``_ProjParams``) has the
    same ``{kernel, bias}`` keys as a Dense.

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


def _torch_key(flax_key: str) -> "tuple[str, bool]":
    """"enc/vit/transformer/layer_0/attn/qkv/kernel" →
    ("enc.vit.transformer.layers.0.attn.qkv.weight", transposed=True)."""
    key = re.sub(r"\blayer_(\d+)\b", r"layers.\1", flax_key.replace("/", "."))
    if key.endswith(".kernel"):
        return key.removesuffix(".kernel") + ".weight", True
    return key, False


def _flax_key(torch_key: str) -> "tuple[str, bool]":
    """Inverse of ``_torch_key``."""
    key = re.sub(r"\blayers\.(\d+)\b", r"layer_\1", torch_key).replace(".", "/")
    if key.endswith("/weight"):
        return key.removesuffix("/weight") + "/kernel", True
    return key, False


def state_dict_from_flax(params: dict, cfg) -> "dict[str, torch.Tensor]":
    """JAX TiTok params (nested dict of arrays) → the port's state dict for a
    ``TiTok(cfg)``. Raises unless every JAX leaf lands on exactly one port
    parameter of the right shape and every port parameter is filled."""
    from vit_tpu_torch.models.titok import TiTok

    expected = TiTok(cfg, device="meta").state_dict()
    out: "dict[str, torch.Tensor]" = {}
    for flax_key, leaf in flatten(params).items():
        key, transpose = _torch_key(flax_key)
        if key not in expected:
            raise KeyError(f"JAX leaf {flax_key!r} has no port parameter "
                           f"({key!r})")
        if key in out:
            raise KeyError(f"port parameter {key!r} filled twice")
        arr = np.array(leaf.T if transpose else leaf, order="C")  # owned copy
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"{flax_key}: shape {arr.shape} does not fit "
                             f"{key} {tuple(expected[key].shape)}")
        out[key] = torch.from_numpy(arr)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing}")
    return out


def flax_from_state_dict(state_dict: dict) -> dict:
    """The port's state dict → the JAX package's nested param dict (numpy)."""
    flat = {}
    for key, t in state_dict.items():
        flax_key, transpose = _flax_key(key)
        arr = t.detach().cpu().numpy()
        flat[flax_key] = np.ascontiguousarray(arr.T if transpose else arr)
    return unflatten(flat)
