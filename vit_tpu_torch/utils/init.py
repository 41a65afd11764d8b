"""Parameter initialisers matching PyTorch module defaults (counterpart of
``vit_tpu/utils/init.py:24-76``), drawn from an explicit ``torch.Generator``.

  - ``nn.Linear``: U(±1/√fan_in) for the weight and the bias;
  - ``pos_emb`` / ``extra_emb`` (embeddings): N(0, 1);
  - ``codebook``: U(±1/C) (``vit_tpu/quantize/vq.py:28-35``).

The JAX package draws from ``jax.random``, which torch cannot reproduce, so
parity tests carry weights across with ``vit_tpu_torch.bridge``; these inits
only give a freshly built model (e.g. ``chip_smoke.py``'s) the same
distributions.
"""

from __future__ import annotations

import math

import torch
from torch import nn


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
            if name in ("pos_emb", "extra_emb"):
                p.normal_(0.0, 1.0, generator=generator)
            elif name == "codebook":
                bound = 1.0 / p.shape[0]
                p.uniform_(-bound, bound, generator=generator)
            else:
                raise ValueError(f"no initialiser for parameter {name!r} of "
                                 f"{type(module).__name__}")
