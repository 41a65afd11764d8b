"""GELU with the fitted tanh-composed erf (counterpart of
``vit_tpu/ops/gelu.py:33-93``).

``tanh_erf`` (the default) computes erf(u) ≈ tanh(u·(c1 + u²·(c3 + u²·c5)))
with u clamped to [-4, 4], the same constants as the JAX package, so both
packages compute the same function (max |gelu err| 5.4e-5 against exact erf).
Its gradient is the JAX package's flat hand-written derivative
(``_tanh_erf_gelu_bwd``), in fp32 and cast back to the input dtype, as a
``torch.autograd.Function``. ``erf`` is the strict-parity escape hatch and
``tanh`` the classic approximation, both with autograd's own derivative;
``$VIT_TPU_GELU`` picks one when the caller does not. Every variant computes
in fp32 and casts back.
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


def tanh_erf_gelu(x: torch.Tensor) -> torch.Tensor:
    """0.5·x·(1 + tanh_erf(x/√2)) in x's dtype (fp32 where it matters)."""
    return 0.5 * x * (1.0 + tanh_erf(x * _INV_SQRT2))


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of ``tanh_erf_gelu``, the flat form: 0.5(1 + t) +
    0.5·x·(1 − t²)·p′(u)/√2 with t = tanh(p(u)), u = clip(x/√2). In the
    clamped region (1 − t²) vanishes, so the derivative saturates to 0/1."""
    u = (x * _INV_SQRT2).clamp(-4.0, 4.0)
    u2 = u * u
    t = torch.tanh(u * (_C1 + u2 * (_C3 + u2 * _C5)))
    dp = _C1 + u2 * (3 * _C3 + u2 * (5 * _C5))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * dp * _INV_SQRT2


class _TanhErfGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return tanh_erf_gelu(x.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() * gelu_grad(x.float())).to(x.dtype)


def gelu(x: torch.Tensor, impl: "str | None" = None) -> torch.Tensor:
    """GELU(x) = 0.5·x·(1 + erf(x/√2)); impl "tanh_erf" (default), "erf" or
    "tanh". None resolves ``$VIT_TPU_GELU``, then "tanh_erf"."""
    impl = impl or os.environ.get("VIT_TPU_GELU") or "tanh_erf"
    if impl == "tanh_erf":
        return _TanhErfGelu.apply(x)
    if impl == "erf":
        return F.gelu(x.float()).to(x.dtype)
    if impl == "tanh":
        return F.gelu(x.float(), approximate="tanh").to(x.dtype)
    raise ValueError(f"unknown gelu impl {impl!r}")
