"""int8 products for frozen weights (counterpart of
``vit_tpu/core/quant.py:44-74, 161-199``).

  * ``quantize_kernel(w)`` — per-output-channel symmetric int8 quantization
    of a (K, N) kernel: ``w ≈ q · scale[None, :]``, scale
    ``max(absmax, 1e-8) / 127``.
  * ``int8_matmul(x, q, scale)`` — dynamic symmetric per-row quantization of
    the activation (absmax over the contraction axis), an int8 × int8 →
    int32 product, then the fp32 rescale ``(y · s_x) · scale``.
  * ``frozen_int8_dense(x, w, b)`` — a dense layer through those products
    for frozen weights (the perceptual net's stage 3 under
    ``--perceptual_quant int8``). Its backward returns dx only, itself an
    int8 product against Wᵀ re-quantized with its own per-channel scales (the
    deliberate approximation of ``_frozen_int8_bwd``, :181-196); w and b get
    no gradient.

Kernels are in the JAX package's (K, N) layout, so a ``nn.Linear`` weight is
passed as ``weight.t()`` (a view). Rounding is half to even, as
``jnp.round``. The int8 products are plain ones, as the JAX package leaves
them to XLA outside any Pallas kernel: ``torch._int_mm`` (on the card it
needs more than 16 rows and K, N multiples of 8).

The serving side (``QuantDense``, ``quantize_params``, ``--quantize int8``)
is not ported yet.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quantize_kernel(w: torch.Tensor):
    """(K, N) → (q int8 (K, N), scale fp32 (N,)) with ``w ≈ q · scale``."""
    w32 = w.float()
    scale = w32.abs().amax(0).clamp_min(_EPS) / 127.0
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def int8_matmul(x: torch.Tensor, kernel_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) float → (..., N) fp32 through an int8 × int8 → int32
    product with a per-row activation scale."""
    x32 = x.float()
    s_x = x32.abs().amax(-1, keepdim=True).clamp_min(_EPS) / 127.0
    x_q = torch.round(x32 / s_x).clamp(-127, 127).to(torch.int8)
    y = torch._int_mm(x_q.reshape(-1, x_q.shape[-1]), kernel_q)
    return y.reshape(*x.shape[:-1], -1).float() * s_x * scale


class FrozenInt8Dense(torch.autograd.Function):
    """(x, w (K, N), b) → fp32 x·w + b in int8; dx only in the backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(w)
        ctx.x_dtype = x.dtype
        wq, ws = quantize_kernel(w)
        return int8_matmul(x, wq, ws) + b.float()

    @staticmethod
    def backward(ctx, dy):
        (w,) = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            wtq, wts = quantize_kernel(w.t())
            dx = int8_matmul(dy, wtq, wts).to(ctx.x_dtype)
        return dx, None, None


def frozen_int8_dense(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Dense through int8 products for frozen weights: w (K, N), b (N,) →
    fp32 (..., N). Gradients flow to x only."""
    return FrozenInt8Dense.apply(x, w, b)
