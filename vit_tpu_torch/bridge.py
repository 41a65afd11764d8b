"""Carry weights between the JAX package's param tree and the port's state dict.

The port names its modules after the flax modules, so one rule maps a flax
leaf path to a state-dict key:

  - path segments join with "." and ``layer_{i}`` becomes ``layers.{i}``;
    the enhancing ViT-VQGAN's flat block names ``attn_norm_{i}``,
    ``attn_{i}``, ``ff_norm_{i}``, ``ff1_{i}`` and ``ff2_{i}`` become
    ``blocks.{i}.attn_norm`` and so on;
  - a Dense ``kernel`` (in, out) becomes ``weight`` (out, in);
  - a Conv ``kernel`` HWIO becomes ``weight`` OIHW; a depthwise kernel
    (7, 7, 1, C) thereby becomes (C, 1, 7, 7);
  - a LayerNorm or GroupNorm ``scale`` becomes ``weight`` (the Bytedance
    block's affine ``ln1``/``ln2``, flax ``nn.LayerNorm``'s and the LlamaGen
    VQ's ``nn.GroupNorm``'s alike);
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

An int8 dense site (``core/quant.py``, the JAX ``quantize_params`` tree)
keeps its JAX names and layout both ways: ``kernel_q`` int8 (K, N), and a
``scale`` beside a ``kernel_q`` stays ``scale`` (the per-channel scale, not
a LayerNorm's).

``flatten``/``unflatten`` convert between the nested dict and the
"/"-joined keys of ``weights.npz`` (the layout of the JAX export's
``_write_artifacts``). Only the unrolled ``layer_{i}`` stack is read; the
scanned ``layers/...`` layout is not.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flat(tree: dict, prefix: str = "") -> dict:
    """Nested dict → {"a/b/c": leaf}, the leaves as they are."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flat(v, key))
        else:
            flat[key] = v
    return flat


def flatten(tree: dict) -> "dict[str, np.ndarray]":
    """Nested dict of arrays → {"a/b/c": array}."""
    return {k: np.asarray(v) for k, v in _flat(tree).items()}


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


# the enhancing ViT-VQGAN's flat per-block names (``attn_norm_0``, ...)
ENHANCING_BLOCK = "attn_norm|attn|ff_norm|ff1|ff2"
ENHANCING_FLAT = r"\b(" + ENHANCING_BLOCK + r")_(\d+)\b"


def _to_torch(leaf):
    """A flax ``kernel`` (numpy or torch) in the port's ``weight`` layout."""
    if leaf.ndim == 2:
        return leaf.T
    return (leaf.permute(3, 2, 0, 1) if torch.is_tensor(leaf)
            else leaf.transpose(3, 2, 0, 1))


def _to_flax(arr):
    """Inverse of ``_to_torch``."""
    if arr.ndim == 2:
        return arr.T
    return (arr.permute(2, 3, 1, 0) if torch.is_tensor(arr)
            else arr.transpose(2, 3, 1, 0))


def _torch_key(flax_key: str) -> "tuple[str, bool]":
    """"enc/vit/transformer/layer_0/attn/qkv/kernel" →
    ("enc.vit.transformer.layers.0.attn.qkv.weight", is_kernel=True)."""
    key = re.sub(r"\blayer_(\d+)\b", r"layers.\1", flax_key.replace("/", "."))
    key = re.sub(ENHANCING_FLAT, r"blocks.\2.\1", key)
    if key.endswith(".kernel"):
        return key.removesuffix(".kernel") + ".weight", True
    if key.endswith(".scale"):
        return key.removesuffix(".scale") + ".weight", False
    return key, False


def _flax_key(torch_key: str, ndim: int) -> "tuple[str, bool]":
    """Inverse of ``_torch_key`` for a tensor of rank ``ndim``."""
    key = re.sub(r"\bblocks\.(\d+)\.(" + ENHANCING_BLOCK + r")\b", r"\2_\1",
                 torch_key)
    key = re.sub(r"\blayers\.(\d+)\b", r"layer_\1", key).replace(".", "/")
    if key.endswith("/weight"):
        if ndim == 1:
            return key.removesuffix("/weight") + "/scale", False
        return key.removesuffix("/weight") + "/kernel", True
    return key, False


def _from_flax(params: dict, expected: dict) -> "dict[str, torch.Tensor]":
    """Nested flax params (numpy arrays, or torch tensors on any device) →
    a state dict with ``expected``'s keys and shapes, on the leaves' device.
    Raises unless every JAX leaf lands on exactly one port parameter of the
    right shape and every port parameter is filled."""
    out: "dict[str, torch.Tensor]" = {}
    flat = _flat(params)
    for flax_key, leaf in flat.items():
        key, is_kernel = _torch_key(flax_key)
        site = flax_key.removesuffix("/scale")
        if site != flax_key and site + "/kernel_q" in flat:
            key = key.removesuffix(".weight") + ".scale"  # an int8 site
        if key not in expected:
            raise KeyError(f"JAX leaf {flax_key!r} has no port parameter "
                           f"({key!r})")
        if key in out:
            raise KeyError(f"port parameter {key!r} filled twice")
        arr = _to_torch(leaf) if is_kernel else leaf
        if torch.is_tensor(arr):
            arr = arr.clone(memory_format=torch.contiguous_format)
        else:
            arr = torch.from_numpy(np.array(arr, order="C"))  # owned copy
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"{flax_key}: shape {tuple(arr.shape)} does not "
                             f"fit {key} {tuple(expected[key].shape)}")
        out[key] = arr
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


def vit_vqgan_state_dict_from_flax(params: dict, cfg
                                   ) -> "dict[str, torch.Tensor]":
    """JAX ViT-VQGAN params (``encoder``/``decoder`` with their ``vit`` and
    projections, ``quant/codebook``) → the port's state dict for a
    ``ViTVQGAN(cfg)``, with the checks of ``_from_flax``."""
    from vit_tpu_torch.models.vit_vqgan import ViTVQGAN

    return _from_flax(params, ViTVQGAN(cfg, device="meta").state_dict())


def enhancing_state_dict_from_flax(params: dict, cfg
                                   ) -> "dict[str, torch.Tensor]":
    """JAX enhancing ViT-VQGAN params (the flat ``attn_norm_{i}`` ...
    ``ff2_{i}`` blocks and ``final_norm`` of each ``transformer``,
    ``patch_embed``, ``to_pixel``, ``pre_quant_proj``, ``quant_proj``,
    ``quant/codebook``) → the port's state dict for an
    ``EnhancingViTVQGAN(cfg)``, with the checks of ``_from_flax``."""
    from vit_tpu_torch.models.enhancing_vqgan import EnhancingViTVQGAN

    return _from_flax(params,
                      EnhancingViTVQGAN(cfg, device="meta").state_dict())


def llamagen_vq_state_dict_from_flax(params: dict, cfg
                                     ) -> "dict[str, torch.Tensor]":
    """JAX LlamaGen VQ params (flax names: ``encoder/down_0_res_0/conv1``,
    HWIO kernels, GroupNorm ``scale``, ``codebook``) → the port's state dict
    for a ``LlamaGenVQ(cfg)``, OIHW, with the checks of ``_from_flax``."""
    from vit_tpu_torch.models.llamagen_vq import LlamaGenVQ

    return _from_flax(params, LlamaGenVQ(cfg, device="meta").state_dict())


def llamagen_titok_state_dict_from_flax(params: dict, cfg
                                        ) -> "dict[str, torch.Tensor]":
    """JAX LlamaGen-TiTok params (``enc``/``dec`` with their tables,
    transformers and projections, ``quant/codebook``) → the port's state
    dict for a ``LlamaGenTiTok(cfg)``, with the checks of ``_from_flax``."""
    from vit_tpu_torch.models.llamagen_titok import LlamaGenTiTok

    return _from_flax(params, LlamaGenTiTok(cfg, device="meta").state_dict())


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


def module_state_dict_from_flax(params: dict, module: torch.nn.Module
                                ) -> "dict[str, torch.Tensor]":
    """JAX params → the state dict of the port's ``module`` (any model the
    bridge's rule covers, int8 trees included), with the checks of
    ``_from_flax``."""
    return _from_flax(params, module.state_dict())


def flax_tree(state_dict: dict) -> dict:
    """The port's state dict → the JAX package's nested param dict of the
    same tensors (kernels as transposed views), on their device; of a model
    built on the meta device, its structure with no data."""
    flat = {}
    for key, t in state_dict.items():
        flax_key, is_kernel = _flax_key(key, t.ndim)
        flat[flax_key] = _to_flax(t.detach()) if is_kernel else t.detach()
    return unflatten(flat)


def flax_from_state_dict(state_dict: dict) -> dict:
    """The port's state dict → the JAX package's nested param dict (numpy)."""
    return unflatten({k: np.ascontiguousarray(t.cpu().numpy())
                      for k, t in _flat(flax_tree(state_dict)).items()})
