"""Parameter initialisers matching PyTorch module defaults (counterpart of
``vit_tpu/utils/init.py:24-76``), drawn from an explicit ``torch.Generator``.

  - ``nn.Linear``: U(±1/√fan_in) for the weight and the bias;
  - embeddings (``pos_emb``, ``extra_emb``, VideoGPT's ``tok_embed`` and
    ``pos_embed``, MAE's ``cls_token`` and ``mask_token``): N(0, 1),
    ``normal_embed_init_`` (``normal_embed_init``, :47-49);
  - ``codebook``: U(±1/C) (``vit_tpu/quantize/vq.py:28-35``);
  - the affine LayerNorms of the Bytedance block: ones and zeros.

``trunc_normal_init(std)`` (a normal truncated at ±2σ, then × std: JAX's
``truncated_normal(-2, 2) * std``, not ``nn.init.trunc_normal_(std=std)``,
whose bounds ±2 are absolute) and ``scaled_normal_init(scale)`` (N(0,
scale²)) are ``vit_tpu/utils/init.py:52-67``'s; ``init_tatitok_`` fills a
TATiTok with them as ``vit_tpu/models/tatitok.py`` does.

``init_convnext_`` fills the perceptual ConvNeXt with the flax initialisers
of ``vit_tpu/losses/perceptual.py``: lecun-normal (a normal truncated at ±2σ,
rescaled to variance 1/fan_in) for every conv and Dense kernel, zero biases,
LayerNorm ones/zeros and the layer scale γ = 1e-6.

The JAX package draws from ``jax.random``, which torch cannot reproduce, so
parity tests carry weights across with ``vit_tpu_torch.bridge``; these inits
only give a freshly built model (e.g. ``chip_smoke.py``'s) the same
distributions.
"""

from __future__ import annotations

import math

import torch
from torch import nn


EMBEDDINGS = ("pos_emb", "extra_emb", "tok_embed", "pos_embed", "cls_token",
              "mask_token")


@torch.no_grad()
def normal_embed_init_(p: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 1) in place, the nn.Embedding default."""
    p.normal_(0.0, 1.0, generator=generator)


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``model`` in place, in registration order.

    The generator's device must be the parameters' device (e.g. build and
    initialise on the CPU, then move the model)."""
    from vit_tpu_torch.core.transformer import LayerNorm

    for module in model.modules():
        if isinstance(module, (LayerNorm, nn.LayerNorm)):
            for name, p in module.named_parameters(recurse=False):
                p.fill_(1.0 if name == "weight" else 0.0)
            continue
        if isinstance(module, nn.Linear):
            bound = 1.0 / math.sqrt(module.in_features)
            module.weight.uniform_(-bound, bound, generator=generator)
            if module.bias is not None:
                module.bias.uniform_(-bound, bound, generator=generator)
            continue
        for name, p in module.named_parameters(recurse=False):
            if name in EMBEDDINGS:
                normal_embed_init_(p, generator)
            elif name == "codebook":
                bound = 1.0 / p.shape[0]
                p.uniform_(-bound, bound, generator=generator)
            else:
                raise ValueError(f"no initialiser for parameter {name!r} of "
                                 f"{type(module).__name__}")


# 2Φ(±2) − 1: the uniform bounds whose inverse CDF spans (−2, 2)
_ERF_2 = math.erf(2.0 / math.sqrt(2.0))


@torch.no_grad()
def standard_trunc_normal_(p: torch.Tensor,
                           generator: torch.Generator) -> torch.Tensor:
    """N(0, 1) truncated to (−2, 2) in place by its inverse CDF, one uniform
    draw an element (as ``jax.random.truncated_normal``; torch's
    ``trunc_normal_`` redraws the whole tensor until no element is out of
    range, several passes over ConvNeXt-S's 50 M weights)."""
    p.uniform_(-_ERF_2, _ERF_2, generator=generator)
    return p.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def trunc_normal_init(std: float):
    """In-place N(0, 1) truncated to (−2, 2), times ``std``."""

    @torch.no_grad()
    def init(p: torch.Tensor, generator: torch.Generator) -> None:
        standard_trunc_normal_(p, generator).mul_(std)

    return init


def scaled_normal_init(scale: float):
    """In-place N(0, scale²): the Bytedance ``scale * randn``."""

    @torch.no_grad()
    def init(p: torch.Tensor, generator: torch.Generator) -> None:
        p.normal_(0.0, scale, generator=generator)

    return init


@torch.no_grad()
def init_tatitok_(model: nn.Module, generator: torch.Generator) -> None:
    """Fill a ``models.tatitok.TATiTok`` in place: trunc_normal(0.02)
    weights and zero biases for its own dense and conv layers, N(0, 1/width)
    for the latent bank, class, mask and positional tables, the affine
    LayerNorms ones and zeros, the transformers as ``init_params_`` and the
    codebook U(±1/C)."""
    from vit_tpu_torch.core.transformer import Transformer

    tn = trunc_normal_init(0.02)
    sn = scaled_normal_init(model.config.width ** -0.5)
    sn(model.latent_tokens, generator)
    for part in (model.encoder, model.decoder):
        for p in part.parameters(recurse=False):
            sn(p, generator)
        for child in part.children():
            if isinstance(child, Transformer):
                init_params_(child, generator)
            elif isinstance(child, nn.LayerNorm):
                child.weight.fill_(1.0)
                child.bias.zero_()
            else:   # nn.Linear or nn.Conv2d
                tn(child.weight, generator)
                child.bias.zero_()
    emb = model.quantize.embedding
    emb.uniform_(-1.0 / emb.shape[0], 1.0 / emb.shape[0], generator=generator)


# stddev of a standard normal truncated to (-2, 2), as flax's variance_scaling
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_convnext_(net: nn.Module, generator: torch.Generator) -> None:
    """Fill a ``losses.perceptual.ConvNeXt`` in place, in registration
    order, from ``generator`` (on the parameters' device)."""
    from vit_tpu_torch.losses.perceptual import Conv, ConvNeXtBlock, LayerNorm

    for module in net.modules():
        if isinstance(module, (Conv, nn.Linear)):
            w = module.weight
            std = math.sqrt(1.0 / math.prod(w.shape[1:])) / _TRUNC_STD
            standard_trunc_normal_(w, generator).mul_(std)
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, ConvNeXtBlock):
            module.gamma.fill_(1e-6)
