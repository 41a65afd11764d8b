"""int8 products for frozen weights and int8 serving (counterpart of
``vit_tpu/core/quant.py``).

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

  * ``QuantProj`` / ``QuantLinear`` — the serving-only counterparts of
    ``QuantProjParams`` and ``QuantDense`` (:77-120): buffers ``kernel_q``
    int8 (K, N) in the JAX layout, ``scale`` fp32 (N,) and ``bias`` fp32.
    ``QuantProj`` hands the three back (the qkv bias goes to the attention
    kernel); ``QuantLinear`` is ``int8_matmul(x) + bias`` in the compute
    dtype. The transformer's dense sites take them under
    ``TransformerConfig.quant == "int8"``.
  * ``quantize_params(target, params_fp)`` — a trained fp tree in the JAX
    layout (nested dicts, "kernel" (K, N)) → the int8 model's tree
    (:123-158).

Kernels are in the JAX package's (K, N) layout, so a ``nn.Linear`` weight is
passed as ``weight.t()`` (a view). Rounding is half to even, as
``jnp.round``. The int8 products are plain ones, as the JAX package leaves
them to XLA outside any Pallas kernel: ``torch._int_mm``. On the card it
needs more than 16 rows and K, N multiples of 8, so ``int8_matmul`` pads a
CUDA product of fewer rows with zero rows (``pad_rows``; a zero row
quantizes to zero) and slices them off again: a VideoGPT decode step has
only the batch's rows.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_EPS = 1e-8
INT_MM_MIN_ROWS = 17   # torch._int_mm on the card takes more than 16 rows


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
    rows = x_q.reshape(-1, x_q.shape[-1])
    n = rows.shape[0]
    if rows.is_cuda:
        rows = pad_rows(rows, INT_MM_MIN_ROWS)
    y = torch._int_mm(rows, kernel_q)[:n]
    return y.reshape(*x.shape[:-1], -1).float() * s_x * scale


def pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """(M, K) → (max(M, rows), K): zero rows appended where M is short."""
    if a.shape[0] >= rows:
        return a
    return torch.cat([a, a.new_zeros(rows - a.shape[0], a.shape[1])])


class QuantProj(nn.Module):
    """An int8 dense site's buffers (``QuantProjParams``): ``kernel_q``
    (fan_in, features) int8, ``scale`` (features,) fp32, ``bias``
    (features,) fp32; the call returns them. Filled by
    ``quantize_params``, never trained."""

    def __init__(self, fan_in: int, features: int, device=None):
        super().__init__()
        self.register_buffer("kernel_q", torch.zeros(
            fan_in, features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            features, dtype=torch.float32, device=device))

    def forward(self):
        return self.kernel_q, self.scale, self.bias


class QuantLinear(QuantProj):
    """Dense through an int8 product (``QuantDense``): x (..., fan_in) →
    ``int8_matmul(x) + bias`` (..., features) in ``dtype``."""

    def __init__(self, fan_in: int, features: int, dtype: torch.dtype,
                 device=None):
        super().__init__(fan_in, features, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (int8_matmul(x, self.kernel_q, self.scale)
                + self.bias).to(self.dtype)


def quantize_params(target: dict, params_fp: dict) -> dict:
    """Fill an int8 model's tree from a trained fp tree, both nested dicts
    in the JAX layout. ``target`` gives the structure (leaves with a
    ``.shape``: tensors, meta tensors or arrays); at every level holding
    ``kernel_q`` the source's ``kernel`` (K, N) becomes (kernel_q, scale)
    by ``quantize_kernel``; every other leaf is copied, so an affine
    LayerNorm's ``scale`` goes through. A leaf of another shape raises.
    Returns CPU tensors."""

    def tensor(a):
        return a if torch.is_tensor(a) else torch.from_numpy(np.array(a))

    def build(tgt, src):
        if not isinstance(tgt, dict):
            src = tensor(src)
            if tuple(tgt.shape) != tuple(src.shape):
                raise ValueError(
                    f"param shape mismatch: target {tuple(tgt.shape)} vs "
                    f"source {tuple(src.shape)}")
            return src
        quant_site = "kernel_q" in tgt
        if quant_site:
            if "kernel" not in src:
                raise ValueError(
                    "quantized site expects a source 'kernel'; source keys: "
                    f"{sorted(src)}")
            kq, sc = quantize_kernel(tensor(src["kernel"]))
            if tuple(kq.shape) != tuple(tgt["kernel_q"].shape):
                raise ValueError(
                    f"param shape mismatch: target kernel_q "
                    f"{tuple(tgt['kernel_q'].shape)} vs source kernel "
                    f"{tuple(kq.shape)}")
        out = {}
        for k, v in tgt.items():
            if quant_site and k == "kernel_q":
                out[k] = kq
            elif quant_site and k == "scale":
                out[k] = sc
            else:
                out[k] = build(v, src[k])
        return out

    return build(target, params_fp)


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
