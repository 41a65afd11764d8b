"""Parameter initialisers matching PyTorch module defaults (counterpart of
``vit_tpu/utils/init.py:24-76``), drawn from an explicit ``torch.Generator``.

  - ``nn.Linear``: U(±1/√fan_in) for the weight and the bias;
  - embeddings (``pos_emb``, ``extra_emb``, VideoGPT's ``tok_embed`` and
    ``pos_embed``, MAE's ``cls_token`` and ``mask_token``): N(0, 1),
    ``normal_embed_init_`` (``normal_embed_init``, :47-49);
  - ``codebook``: U(±1/C) (``vit_tpu/quantize/vq.py:28-35``).

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
    for module in model.modules():
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
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.mul_(std)
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, ConvNeXtBlock):
            module.gamma.fill_(1e-6)
