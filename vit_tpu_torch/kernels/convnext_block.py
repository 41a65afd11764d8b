"""K3 and K4: the frozen ConvNeXt block tail, forward and input gradient
(CUDA C++, ``csrc/convnext_tail.cu``); K12a and K12b: their int8 variants
(``csrc/convnext_tail_q8.cu``).

K3 replaces the Pallas kernel ``vit_tpu/kernels/convnext_block.py:_fwd_kernel``
(:89, launched by ``_fwd_impl`` :248) and K4 ``_bwd_kernel`` (:109, launched
by ``_bwd_impl`` :276), behind ``frozen_convnext_block_tail`` (:457). On rows
(N, C), the flattened B·H·W of a channels-last activation:

    y = x + γ ⊙ (gelu(LN(h)·W1 + b1)·W2 + b2)

and, for the backward, dh recomputed from h (dx = dy needs no kernel).

K12a replaces ``_fwd_kernel_q8`` (:148, launched by ``_fwd_impl_q8`` :310)
and K12b ``_bwd_kernel_q8`` (:172, launched by ``_bwd_impl_q8`` :342), the
``quant="int8"`` tail: both products (and both of the backward) run int8 ×
int8 → int32 with dynamic per-row activation scales (``quant_rows``,
:140-145) and per-output-channel weight scales (``quant_cols``, :204-212),
the weights quantized in the wrapper, outside the kernel, as ``_fwd_impl_q8``
and ``_bwd_impl_q8`` quantize them in XLA (:305-308, :338-340). Both helpers
compute ``max(absmax, 1e-8) · (1/127)``, a multiply by the reciprocal, where
``core/quant.py`` divides by 127: each site keeps its own form, so the scales
are the JAX package's to the bit.

What bounds them on the H100: 16·C² FLOP per row forward and 24·C² backward
against 6·C bytes of rows, with the (N, 4C) intermediate and the LN output
kept out of device memory as on the TPU (but for K12b's dz: its first pass
stores it in fp32 scratch of the call and its second reads it back, which
measured faster than forming it twice). The weights do not fit in shared
memory at C = 384, so a block of 64 or 128 rows streams the 4C dimension in
chunks of W1 and W2 tiles (by TMA into a ring, read by wgmma in the
orientation each product needs) and keeps its output accumulator in
registers (see the sources' headers).

FROZEN-WEIGHT CONTRACT, as in the JAX package: gradients flow to h and x
only. :class:`ConvNeXtTail` returns ``None`` for the seven parameters and
refuses parameters that require grad.

Weights are passed in PyTorch's Linear layout: ``w1`` (4C, C) and ``w2``
(C, 4C). Each wrapper launches its kernel for a CUDA tensor (bf16 or fp32
rows, C ∈ ``CUDA_DIMS``) and runs its plain PyTorch version for a CPU
tensor. The parameters are cast to the rows' dtype, as the JAX package
casts them to the compute dtype; fp32 rows launch the fp32 forms, counted
apart in ``fp32_*``: for K3 and K4 ``csrc/convnext_tail.cu``'s kernels over
three bf16 parts of each operand (``kParts = 3``, after the weights'
pre-split, :func:`split_weights`, into scratch of each call; K4 at C 384
with a z pre-pass into more scratch), for K12a/K12b the fp32-row
instantiations of ``csrc/convnext_tail_q8.cu``.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.kernels import _build
from vit_tpu_torch.kernels.attention import split3
from vit_tpu_torch.ops.gelu import gelu_grad, tanh_erf_gelu

MAX_FUSED_DIM = 384    # the JAX package's gate (a VMEM bound on the TPU)
CUDA_DIMS = (96, 192, 384)  # the widths the CUDA kernels are built for

launches = 0      # K3 launches by convnext_tail_fwd, for run evidence
bwd_launches = 0  # K4 launches by convnext_tail_bwd
q8_launches = 0      # K12a launches by convnext_tail_fwd_q8
q8_bwd_launches = 0  # K12b launches by convnext_tail_bwd_q8
# Of those, the launches of the fp32 forms, per wrapper
fp32_launches = fp32_bwd_launches = 0
q8_fp32_launches = q8_fp32_bwd_launches = 0
QUANTS = ("none", "int8")


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
    _build.compute_dtype(kernel, h, *rows)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    n, c = h.shape
    if c not in CUDA_DIMS:
        raise NotImplementedError(f"{kernel} is built for C in {CUDA_DIMS}, "
                                  f"got {c}")
    for t in (h, *rows):
        if t.shape != (n, c) or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel} takes contiguous, 16-byte aligned "
                             f"({n}, {c}) rows, got {tuple(t.shape)}")


def _weights(h: torch.Tensor, *params: torch.Tensor) -> list:
    """The parameters in the rows' dtype (the compute dtype), laid out for
    the kernels."""
    return [_build.cuda_arg(p, h, "parameter", h.dtype) for p in params]


def _shapes(c: int, lns, lnb, w1, b1, w2, b2=None, gamma=None) -> None:
    want = dict(lns=(c,), lnb=(c,), w1=(4 * c, c), b1=(4 * c,),
                w2=(c, 4 * c), b2=(c,), gamma=(c,))
    got = dict(lns=lns, lnb=lnb, w1=w1, b1=b1, w2=w2, b2=b2, gamma=gamma)
    for k, t in got.items():
        if t is not None and tuple(t.shape) != want[k]:
            raise ValueError(f"{k} must be {want[k]}, got {tuple(t.shape)}")


def split_weights_ref(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain version of K3 fp32's pre-split: w1 (4C, C) and w2 (C, 4C)
    fp32 → (2, 3, 4C·C) bf16, weight w's part p at [w, p] (``split3``)."""
    return torch.stack([torch.stack(split3(w.reshape(-1))) for w in (w1, w2)])


def _split(lib, w1: torch.Tensor, w2: torch.Tensor, stream) -> torch.Tensor:
    """Launch the pre-split (``convnext_tail_split``) of fp32 w1 and w2 on
    ``stream`` into new scratch; returns the parts."""
    c = w1.shape[1]
    parts = torch.empty(2, 3, 4 * c * c, dtype=torch.bfloat16,
                        device=w1.device)
    err = lib.convnext_tail_split(w1.data_ptr(), w2.data_ptr(),
                                  parts.data_ptr(), c, stream)
    _build.check(lib, err, "convnext_tail_split")
    return parts


def split_weights(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """K3 and K4 fp32's pre-split alone, the launch its wrapper makes before the
    kernel, to check it against :func:`split_weights_ref` and time it: CUDA
    w1 (4C, C) and w2 (C, 4C), cast to fp32 → (2, 3, 4C·C) bf16."""
    c = w1.shape[1]
    if w1.shape != (4 * c, c) or w2.shape != (c, 4 * c):
        raise ValueError(f"w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} "
                         f"are not (4C, C) and (C, 4C)")
    if w1.device.type != "cuda":
        raise ValueError(f"unsupported device {w1.device}")
    w1, w2 = (_build.cuda_arg(w, w1, "weight", torch.float32)
              for w in (w1, w2))
    lib = _build.load()
    with torch.cuda.device(w1.device):
        return _split(lib, w1, w2,
                      torch.cuda.current_stream(w1.device).cuda_stream)


def convnext_tail_fwd(h, x, lns, lnb, w1, b1, w2, b2, gamma, eps=1e-6):
    """K3: y = x + γ ⊙ (gelu(LN(h)·W1 + b1)·W2 + b2) on (N, C) rows. fp32
    rows first launch the weights' pre-split into scratch of this call."""
    _shapes(h.shape[1], lns, lnb, w1, b1, w2, b2, gamma)
    if h.device.type == "cpu":
        return convnext_tail_fwd_ref(h, x, lns, lnb, w1, b1, w2, b2, gamma, eps)
    _check_cuda(h, (x,), "K3")
    n, c = h.shape
    lns, lnb, w1, b1, w2, b2, gamma = _weights(h, lns, lnb, w1, b1, w2, b2,
                                               gamma)
    y = torch.empty_like(h)
    f32 = h.dtype == torch.float32
    entry = "convnext_tail_f32_fwd" if f32 else "convnext_tail_fwd"
    lib = _build.load()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if f32:
            parts = _split(lib, w1, w2, stream)
            err = lib.convnext_tail_f32_fwd(
                h.data_ptr(), x.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
                parts.data_ptr(), b1.data_ptr(), b2.data_ptr(),
                gamma.data_ptr(), y.data_ptr(), n, c, eps, stream)
        else:
            err = lib.convnext_tail_fwd(
                h.data_ptr(), x.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                gamma.data_ptr(), y.data_ptr(), n, c, eps, stream)
    _build.check(lib, err, entry)
    global launches, fp32_launches
    launches += 1
    fp32_launches += f32
    return y


def convnext_tail_bwd(h, dy, lns, lnb, w1, b1, w2, gamma, eps=1e-6):
    """K4: dh from dy on (N, C) rows, recomputing the forward from h."""
    _shapes(h.shape[1], lns, lnb, w1, b1, w2, gamma=gamma)
    if h.device.type == "cpu":
        return convnext_tail_bwd_ref(h, dy, lns, lnb, w1, b1, w2, gamma, eps)
    _check_cuda(h, (dy,), "K4")
    n, c = h.shape
    lns, lnb, w1, b1, w2, gamma = _weights(h, lns, lnb, w1, b1, w2, gamma)
    dh = torch.empty_like(h)
    lib = _build.load()
    f32 = h.dtype == torch.float32
    entry = "convnext_tail_f32_bwd" if f32 else "convnext_tail_bwd"
    # both forms read W1 and W2 in the orientation each product needs
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if f32:
            parts = _split(lib, w1, w2, stream)
            # gelu'(z + b1) from the z pre-pass, where the form takes one
            gz = (torch.empty(n, 4 * c, dtype=torch.float32, device=h.device)
                  if lib.convnext_tail_f32_bwd_gz(c) else None)
            err = lib.convnext_tail_f32_bwd(
                h.data_ptr(), dy.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
                parts.data_ptr(), b1.data_ptr(), gamma.data_ptr(),
                None if gz is None else gz.data_ptr(), dh.data_ptr(), n, c,
                eps, stream)
        else:
            err = lib.convnext_tail_bwd(
                h.data_ptr(), dy.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), gamma.data_ptr(),
                dh.data_ptr(), n, c, eps, stream)
    _build.check(lib, err, entry)
    global bwd_launches, fp32_bwd_launches
    bwd_launches += 1
    fp32_bwd_launches += f32
    return dh


def quant_rows(v32: torch.Tensor):
    """Per-row symmetric int8 quantization (``_quant_rows``, :140-145):
    v ≈ q · s with s = max(absmax, 1e-8) · (1/127), (N, 1) fp32."""
    s = v32.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    q = torch.round(v32 / s).clamp(-127, 127).to(torch.int8)
    return q, s


def quant_cols(w: torch.Tensor):
    """Per-output-channel symmetric int8 quantization of a (K, N) matrix
    (``_quant_cols``, :204-212): q (K, N) int8, s (N,) fp32."""
    w32 = w.float()
    s = w32.abs().amax(0).clamp_min(1e-8) * (1.0 / 127.0)
    q = torch.round(w32 / s).clamp(-127, 127).to(torch.int8)
    return q, s


def convnext_tail_fwd_q8_ref(h, x, lns, lnb, w1, b1, w2, b2, gamma, eps):
    """Plain version of K12a (``_fwd_kernel_q8``): rows (N, C), w1 (4C, C),
    w2 (C, 4C) → y (N, C) in h's dtype. u and a = gelu(z) are quantized per
    row in fp32, without a cast to the compute dtype."""
    dt = h.dtype
    # the vectors in the compute dtype, read in fp32 (:324-325); the weights
    # quantized from their fp32 values
    lns, lnb, b1, b2, gamma = (p.float() for p in _prep(dt, lns, lnb, b1, b2,
                                                        gamma))
    w1q, w1s = quant_cols(w1.t())                     # (C, 4C), (4C,)
    w2q, w2s = quant_cols(w2.t())                     # (4C, C), (C,)
    uhat, _ = _normalize(h, eps)
    uq, us = quant_rows(uhat * lns + lnb)
    z = torch._int_mm(uq, w1q).float() * us * w1s + b1
    aq, as_ = quant_rows(tanh_erf_gelu(z))
    o = torch._int_mm(aq, w2q).float() * as_ * w2s + b2
    return (x.float() + gamma * o).to(dt)


def convnext_tail_bwd_q8_ref(h, dy, lns, lnb, w1, b1, w2, gamma, eps):
    """Plain version of K12b (``_bwd_kernel_q8``): dh (N, C) in h's dtype.
    z is recomputed with the forward's int8 arithmetic; da = do·W2ᵀ and
    du = dz·W1ᵀ are int8 products against the transposed weights quantized
    with their own per-channel scales."""
    dt = h.dtype
    lns, lnb, b1, gamma = (p.float() for p in _prep(dt, lns, lnb, b1, gamma))
    w1q, w1s = quant_cols(w1.t())                     # W1: (C, 4C)
    w1tq, w1ts = quant_cols(w1)                       # W1ᵀ: (4C, C)
    w2tq, w2ts = quant_cols(w2)                       # W2ᵀ: (C, 4C)
    uhat, rstd = _normalize(h, eps)
    uq, us = quant_rows(uhat * lns + lnb)
    z = torch._int_mm(uq, w1q).float() * us * w1s + b1
    doq, dos = quant_rows(dy.float() * gamma)
    da = torch._int_mm(doq, w2tq).float() * dos * w2ts
    dzq, dzs = quant_rows(da * gelu_grad(z))
    du = torch._int_mm(dzq, w1tq).float() * dzs * w1ts
    dhat = du * lns
    c1 = dhat.mean(-1, keepdim=True)
    c2 = (dhat * uhat).mean(-1, keepdim=True)
    return (rstd * (dhat - c1 - uhat * c2)).to(dt)


def convnext_tail_fwd_q8(h, x, lns, lnb, w1, b1, w2, b2, gamma, eps=1e-6):
    """K12a: the int8 tail forward on (N, C) rows."""
    _shapes(h.shape[1], lns, lnb, w1, b1, w2, b2, gamma)
    if h.device.type == "cpu":
        return convnext_tail_fwd_q8_ref(h, x, lns, lnb, w1, b1, w2, b2, gamma,
                                        eps)
    _check_cuda(h, (x,), "K12a")
    n, c = h.shape
    lns, lnb, b1, b2, gamma = _weights(h, lns, lnb, b1, b2, gamma)
    w1q, w1s = quant_cols(w1.t())
    w2q, w2s = quant_cols(w2.t())
    # (n, k) operands, k contiguous: W1 (4C, C), W2 (C, 4C)
    w1q, w2q = (_build.cuda_arg(q.t(), h, "weight", torch.int8)
                for q in (w1q, w2q))
    y = torch.empty_like(h)
    f32 = h.dtype == torch.float32
    entry = "convnext_tail_fwd_q8_f32" if f32 else "convnext_tail_fwd_q8"
    lib = _build.load()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = getattr(lib, entry)(
            h.data_ptr(), x.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
            w1q.data_ptr(), w1s.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
            w2s.data_ptr(), b2.data_ptr(), gamma.data_ptr(), y.data_ptr(), n,
            c, eps, stream)
    _build.check(lib, err, entry)
    global q8_launches, q8_fp32_launches
    q8_launches += 1
    q8_fp32_launches += f32
    return y


def convnext_tail_bwd_q8(h, dy, lns, lnb, w1, b1, w2, gamma, eps=1e-6):
    """K12b: dh from dy on (N, C) rows through int8 products."""
    _shapes(h.shape[1], lns, lnb, w1, b1, w2, gamma=gamma)
    if h.device.type == "cpu":
        return convnext_tail_bwd_q8_ref(h, dy, lns, lnb, w1, b1, w2, gamma, eps)
    _check_cuda(h, (dy,), "K12b")
    n, c = h.shape
    lns, lnb, b1, gamma = _weights(h, lns, lnb, b1, gamma)
    w1q, w1s = quant_cols(w1.t())
    w1tq, w1ts = quant_cols(w1)
    w2tq, w2ts = quant_cols(w2)
    # (n, k) operands, k contiguous: W1 (4C, C) for z, W2ᵀ (4C, C) for da,
    # W1ᵀ (C, 4C) for du
    w1q, w2tq, w1tq = (_build.cuda_arg(q.t(), h, "weight", torch.int8)
                       for q in (w1q, w2tq, w1tq))
    dh = torch.empty_like(h)
    f32 = h.dtype == torch.float32
    entry = "convnext_tail_bwd_q8_f32" if f32 else "convnext_tail_bwd_q8"
    lib = _build.load()
    # dz, stored by the kernel's first pass and read back by its second:
    # scratch of the call, 64-row blocks of 4C fp32 values
    dz = torch.empty(-(-n // 64) * 64 * 4 * c, dtype=torch.float32,
                     device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = getattr(lib, entry)(
            h.data_ptr(), dy.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
            w1q.data_ptr(), w1s.data_ptr(), w2tq.data_ptr(), w2ts.data_ptr(),
            w1tq.data_ptr(), w1ts.data_ptr(), b1.data_ptr(), gamma.data_ptr(),
            dh.data_ptr(), dz.data_ptr(), n, c, eps, stream)
    _build.check(lib, err, entry)
    global q8_bwd_launches, q8_fp32_bwd_launches
    q8_bwd_launches += 1
    q8_fp32_bwd_launches += f32
    return dh


class ConvNeXtTail(torch.autograd.Function):
    """(h, x, 7 frozen params) → y; the backward returns dh from K4 (K12b
    under ``quant="int8"``), dy itself for x, and None for the parameters
    (``_tail_bwd``, :442-447). ``eps`` and ``quant`` are not differentiable
    (``nondiff_argnums``, :432). The kernels are looked up in this module
    when called, so a caller can route them elsewhere (``chip_smoke.py``'s
    plain-version run does)."""

    @staticmethod
    def forward(ctx, h, x, lns, lnb, w1, b1, w2, b2, gamma, eps, quant):
        params = (lns, lnb, w1, b1, w2, b2, gamma)
        if any(p.requires_grad for p in params):
            raise ValueError("the fused ConvNeXt tail is for a frozen net: "
                             "its parameters get no gradient")
        if quant not in QUANTS:
            raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
        ctx.save_for_backward(h, lns, lnb, w1, b1, w2, gamma)
        ctx.eps, ctx.quant, ctx.dtype = eps, quant, h.dtype
        fwd = convnext_tail_fwd_q8 if quant == "int8" else convnext_tail_fwd
        return fwd(h, x, *params, eps)

    @staticmethod
    def backward(ctx, dy):
        h, lns, lnb, w1, b1, w2, gamma = ctx.saved_tensors
        dh = None
        if ctx.needs_input_grad[0]:
            bwd = (convnext_tail_bwd_q8 if ctx.quant == "int8"
                   else convnext_tail_bwd)
            dh = bwd(h, dy.to(ctx.dtype).contiguous(), lns, lnb, w1, b1, w2,
                     gamma, ctx.eps)
        return (dh, dy if ctx.needs_input_grad[1] else None,
                *([None] * 9))


def frozen_convnext_block_tail(h, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                               *, eps: float = 1e-6,
                               quant: str = "none") -> torch.Tensor:
    """y = x + γ ⊙ (gelu(LN(h)·W1 + b1)·W2 + b2) on (N, C) rows; w1 (4C, C)
    and w2 (C, 4C) in PyTorch's Linear layout. Gradients flow to h and x
    only. ``quant="int8"`` runs both products (and the backward's two) as
    int8 × int8 → int32 (K12a/K12b). The caller checks
    ``fused_supported(C, 4C)``."""
    return ConvNeXtTail.apply(h, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                              eps, quant)
