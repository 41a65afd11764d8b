"""GELU with the fitted tanh-composed erf (counterpart of
``vit_tpu/ops/gelu.py:33-93``).

``tanh_erf`` (the default) computes erf(u) ≈ tanh(u·(c1 + u²·(c3 + u²·c5)))
with u clamped to [-4, 4], the same constants as the JAX package, so both
packages compute the same function (max |gelu err| 5.4e-5 against exact erf).
``erf`` is the strict-parity escape hatch and ``tanh`` the classic
approximation; ``$VIT_TPU_GELU`` picks one when the caller does not. Every
variant computes in fp32 and casts back. Forward only: the flat custom
backward arrives with training.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

_INV_SQRT2 = 0.7071067811865476
# minimax fit of erf(u) = tanh(c1·u + c3·u³ + c5·u⁵) on u ∈ [0, 6]
_C1, _C3, _C5 = 1.12814338, 0.10408119, -0.00178647


def tanh_erf(u: torch.Tensor) -> torch.Tensor:
    """erf via the tanh-composed odd quintic (max err 3.7e-5)."""
    u = u.clamp(-4.0, 4.0)
    u2 = u * u
    return torch.tanh(u * (_C1 + u2 * (_C3 + u2 * _C5)))


def gelu(x: torch.Tensor, impl: "str | None" = None) -> torch.Tensor:
    """GELU(x) = 0.5·x·(1 + erf(x/√2)); impl "tanh_erf" (default), "erf" or
    "tanh". None resolves ``$VIT_TPU_GELU``, then "tanh_erf"."""
    impl = impl or os.environ.get("VIT_TPU_GELU") or "tanh_erf"
    xf = x.float()
    if impl == "erf":
        y = F.gelu(xf)
    elif impl == "tanh":
        y = F.gelu(xf, approximate="tanh")
    elif impl == "tanh_erf":
        y = 0.5 * xf * (1.0 + tanh_erf(xf * _INV_SQRT2))
    else:
        raise ValueError(f"unknown gelu impl {impl!r}")
    return y.to(x.dtype)
