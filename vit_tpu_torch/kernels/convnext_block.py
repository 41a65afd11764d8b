"""K3 and K4: the frozen ConvNeXt block tail, forward and input gradient
(CUDA C++, ``csrc/convnext_tail.cu``).

K3 replaces the Pallas kernel ``vit_tpu/kernels/convnext_block.py:_fwd_kernel``
(:89, launched by ``_fwd_impl`` :248) and K4 ``_bwd_kernel`` (:109, launched
by ``_bwd_impl`` :276), behind ``frozen_convnext_block_tail`` (:457). On rows
(N, C), the flattened B·H·W of a channels-last activation:

    y = x + γ ⊙ (gelu(LN(h)·W1 + b1)·W2 + b2)

and, for the backward, dh recomputed from h (dx = dy needs no kernel).

What bounds them on the H100: 16·C² FLOP per row forward and 24·C² backward
against 6·C bytes of rows, with the (N, 4C) intermediate and the LN output
kept out of device memory as on the TPU. The weights do not fit in shared
memory at C = 384, so a 64-row block streams the 4C dimension in chunks and
keeps a 64 × C fp32 accumulator in registers (see the source's header).

FROZEN-WEIGHT CONTRACT, as in the JAX package: gradients flow to h and x
only. :class:`ConvNeXtTail` returns ``None`` for the seven parameters and
refuses parameters that require grad.

Weights are passed in PyTorch's Linear layout: ``w1`` (4C, C) and ``w2``
(C, 4C). Each wrapper launches its kernel for a CUDA tensor (bf16,
C ∈ ``CUDA_DIMS``) and runs its plain PyTorch version for a CPU tensor.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.kernels import _build
from vit_tpu_torch.ops.gelu import gelu_grad, tanh_erf_gelu

MAX_FUSED_DIM = 384    # the JAX package's gate (a VMEM bound on the TPU)
CUDA_DIMS = (96, 192, 384)  # the widths the CUDA kernels are built for

launches = 0      # K3 launches by convnext_tail_fwd, for run evidence
bwd_launches = 0  # K4 launches by convnext_tail_bwd


def fused_supported(c: int, c4: int) -> bool:
    """The JAX package's gate: C ≤ 384 and a 4× expansion."""
    return c <= MAX_FUSED_DIM and c4 == 4 * c


def _normalize(h: torch.Tensor, eps: float):
    """Per-row two-pass LN statistics in fp32 → (û, rstd)."""
    h32 = h.float()
    mu = h32.mean(-1, keepdim=True)
    d = h32 - mu
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    return d * rstd, rstd


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a · wᵀ with a and w rounded to the compute dtype first and an fp32
    result, as the kernels' products (bf16 in, fp32 accumulate)."""
    return a.float() @ w.float().t()


def _prep(dt: torch.dtype, *params: torch.Tensor):
    """Every parameter cast to the compute dtype, as ``_fwd_impl`` and
    ``_bwd_impl`` cast them (:261-262, :290-292); then read in fp32."""
    return [p.to(dt) for p in params]


def convnext_tail_fwd_ref(h, x, lns, lnb, w1, b1, w2, b2, gamma, eps):
    """Plain version of K3 (``_fwd_kernel``): rows (N, C), w1 (4C, C),
    w2 (C, 4C) → y (N, C) in h's dtype."""
    dt = h.dtype
    lns, lnb, w1, b1, w2, b2, gamma = _prep(dt, lns, lnb, w1, b1, w2, b2,
                                             gamma)
    uhat, _ = _normalize(h, eps)
    u = (uhat * lns.float() + lnb.float()).to(dt)
    a = tanh_erf_gelu(_mm(u, w1) + b1.float()).to(dt)
    o = _mm(a, w2) + b2.float()
    return (x.float() + gamma.float() * o).to(dt)


def convnext_tail_bwd_ref(h, dy, lns, lnb, w1, b1, w2, gamma, eps):
    """Plain version of K4 (``_bwd_kernel``): dh (N, C) in h's dtype."""
    dt = h.dtype
    lns, lnb, w1, b1, w2, gamma = _prep(dt, lns, lnb, w1, b1, w2, gamma)
    uhat, rstd = _normalize(h, eps)
    u = (uhat * lns.float() + lnb.float()).to(dt)
    z = _mm(u, w1) + b1.float()
    do = (dy.float() * gamma.float()).to(dt)
    da = do.float() @ w2.float()                      # do · W2ᵀ
    dz = (da * gelu_grad(z)).to(dt)
    du = dz.float() @ w1.float()                      # dz · W1ᵀ
    dhat = du * lns.float()
    c1 = dhat.mean(-1, keepdim=True)
    c2 = (dhat * uhat).mean(-1, keepdim=True)
    return (rstd * (dhat - c1 - uhat * c2)).to(dt)


def _check_cuda(h: torch.Tensor, rows: "tuple[torch.Tensor, ...]",
                kernel: str) -> None:
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    n, c = h.shape
    if c not in CUDA_DIMS:
        raise NotImplementedError(f"{kernel} is built for C in {CUDA_DIMS}, "
                                  f"got {c}")
    for t in (h, *rows):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} takes bf16 rows, got {t.dtype}")
        if t.shape != (n, c) or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel} takes contiguous, 16-byte aligned "
                             f"({n}, {c}) rows, got {tuple(t.shape)}")


def _weights(h: torch.Tensor, *params: torch.Tensor) -> list:
    return [_build.cuda_arg(p, h, "parameter", torch.bfloat16)
            for p in params]


def _shapes(c: int, lns, lnb, w1, b1, w2, b2=None, gamma=None) -> None:
    want = dict(lns=(c,), lnb=(c,), w1=(4 * c, c), b1=(4 * c,),
                w2=(c, 4 * c), b2=(c,), gamma=(c,))
    got = dict(lns=lns, lnb=lnb, w1=w1, b1=b1, w2=w2, b2=b2, gamma=gamma)
    for k, t in got.items():
        if t is not None and tuple(t.shape) != want[k]:
            raise ValueError(f"{k} must be {want[k]}, got {tuple(t.shape)}")


def convnext_tail_fwd(h, x, lns, lnb, w1, b1, w2, b2, gamma, eps=1e-6):
    """K3: y = x + γ ⊙ (gelu(LN(h)·W1 + b1)·W2 + b2) on (N, C) rows."""
    _shapes(h.shape[1], lns, lnb, w1, b1, w2, b2, gamma)
    if h.device.type == "cpu":
        return convnext_tail_fwd_ref(h, x, lns, lnb, w1, b1, w2, b2, gamma, eps)
    _check_cuda(h, (x,), "K3")
    n, c = h.shape
    lns, lnb, w1, b1, w2, b2, gamma = _weights(h, lns, lnb, w1, b1, w2, b2,
                                               gamma)
    y = torch.empty_like(h)
    lib = _build.load()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.convnext_tail_fwd(
            h.data_ptr(), x.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            gamma.data_ptr(), y.data_ptr(), n, c, eps, stream)
    _build.check(lib, err, "convnext_tail_fwd")
    global launches
    launches += 1
    return y


def convnext_tail_bwd(h, dy, lns, lnb, w1, b1, w2, gamma, eps=1e-6):
    """K4: dh from dy on (N, C) rows, recomputing the forward from h."""
    _shapes(h.shape[1], lns, lnb, w1, b1, w2, gamma=gamma)
    if h.device.type == "cpu":
        return convnext_tail_bwd_ref(h, dy, lns, lnb, w1, b1, w2, gamma, eps)
    _check_cuda(h, (dy,), "K4")
    n, c = h.shape
    lns, lnb, w1, b1, w2, gamma = _weights(h, lns, lnb, w1, b1, w2, gamma)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    dh = torch.empty_like(h)
    lib = _build.load()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.convnext_tail_bwd(
            h.data_ptr(), dy.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
            w1.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), b1.data_ptr(),
            gamma.data_ptr(), dh.data_ptr(), n, c, eps, stream)
    _build.check(lib, err, "convnext_tail_bwd")
    global bwd_launches
    bwd_launches += 1
    return dh


class ConvNeXtTail(torch.autograd.Function):
    """(h, x, 7 frozen params) → y; the backward returns dh from K4, dy
    itself for x, and None for the parameters (``_tail_bwd``, :442-447). Both
    kernels are looked up in this module when called, so a caller can route
    them elsewhere (``chip_smoke.py``'s plain-version run does)."""

    @staticmethod
    def forward(ctx, h, x, lns, lnb, w1, b1, w2, b2, gamma, eps):
        params = (lns, lnb, w1, b1, w2, b2, gamma)
        if any(p.requires_grad for p in params):
            raise ValueError("the fused ConvNeXt tail is for a frozen net: "
                             "its parameters get no gradient")
        ctx.save_for_backward(h, lns, lnb, w1, b1, w2, gamma)
        ctx.eps = eps
        return convnext_tail_fwd(h, x, *params, eps)

    @staticmethod
    def backward(ctx, dy):
        h, lns, lnb, w1, b1, w2, gamma = ctx.saved_tensors
        dh = None
        if ctx.needs_input_grad[0]:
            dh = convnext_tail_bwd(h, dy.contiguous(), lns, lnb, w1, b1, w2,
                                   gamma, ctx.eps)
        return (dh, dy if ctx.needs_input_grad[1] else None,
                *([None] * 8))


def frozen_convnext_block_tail(h, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                               *, eps: float = 1e-6) -> torch.Tensor:
    """y = x + γ ⊙ (gelu(LN(h)·W1 + b1)·W2 + b2) on (N, C) rows; w1 (4C, C)
    and w2 (C, 4C) in PyTorch's Linear layout. Gradients flow to h and x
    only. The caller checks ``fused_supported(C, 4C)``."""
    return ConvNeXtTail.apply(h, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                              eps)
