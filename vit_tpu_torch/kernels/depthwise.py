"""K11a and K11b: the 7×7 SAME depthwise convolution on channels-last
activations, forward and backward (CUDA C++, ``csrc/depthwise.cu``).

K11a replaces the Pallas kernel ``vit_tpu/kernels/depthwise.py:_dw_kernel``
(:24, launched by ``_dw_forward`` :44) and K11b ``_dw_bwd_kernel`` (:77,
launched by ``_dw_bwd`` :124), behind ``depthwise_conv`` (:68), ConvNeXt's
spatial mixer under ``dw_impl="pallas"``. On x (N, H, W, C), w (k, k, C)
and b (C,):

    y[n, i, j, c] = b[c] + Σ_{di, dj} x[n, i + di − p, j + dj − p, c] · w[di, dj, c]

with zero padding p = k // 2, an fp32 accumulator that starts from the bias
and adds the taps di-major, and one rounding to x's dtype. The backward
computes, in one pass as the Pallas kernel does, dx (the same loop over g
with the flipped taps, in x's dtype) and dw, db (summed over the batch in
fp32; the autograd Function casts them to w's dtype).

What bounds them on the H100: 2·k² fp32 operations per output element
against one read of x and one write of y (3 tensors for K11b): at k 7 the
bytes and the fp32 rate (67 TFLOP/s) give about the same bound. The TPU
kernel holds one halo-padded image in VMEM; here a block holds a
(rows + 6) × (columns + 6) × 32-channel halo tile in shared memory (see the
source's header).

The lax path (``losses/perceptual.py``'s ``F.conv2d``) rounds the
convolution before it adds the bias; these kernels and their plain versions
follow the Pallas kernel, so the two differ in bf16.

Each wrapper launches its kernel for a CUDA tensor (bf16 or fp32, C a
multiple of 8, k = 7) and runs its plain PyTorch version for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_tpu_torch.kernels import _build

CUDA_KSIZE = 7   # the tap count the CUDA kernels are built for

launches = 0      # K11a launches by depthwise_fwd, for run evidence
bwd_launches = 0  # K11b launches by depthwise_bwd


def _pad(t: torch.Tensor, p: int) -> torch.Tensor:
    """(N, H, W, C) in fp32, zero-padded by p on H and W."""
    return F.pad(t.float(), (0, 0, p, p, p, p))


def depthwise_fwd_ref(x, w, b, ksize: int = 7):
    """Plain version of K11a (``_dw_kernel``): x (N, H, W, C), w (k, k, C),
    b (C,) → y (N, H, W, C) in x's dtype."""
    n, h, wd, c = x.shape
    xp, w32 = _pad(x, ksize // 2), w.float()
    acc = b.float().expand(n, h, wd, c)
    for di in range(ksize):
        for dj in range(ksize):
            acc = acc + xp[:, di:di + h, dj:dj + wd] * w32[di, dj]
    return acc.to(x.dtype)


def depthwise_bwd_ref(x, g, w, ksize: int = 7):
    """Plain version of K11b (``_dw_bwd_kernel``): (dx in x's dtype,
    dw (k, k, C) fp32, db (C,) fp32)."""
    n, h, wd, c = x.shape
    p = ksize // 2
    xp, gp, g32 = _pad(x, p), _pad(g, p), g.float()
    wf = w.flip(0, 1).float()
    acc = torch.zeros_like(g32)
    dw = torch.empty(ksize, ksize, c, device=x.device)
    for di in range(ksize):
        for dj in range(ksize):
            acc = acc + gp[:, di:di + h, dj:dj + wd] * wf[di, dj]
            dw[di, dj] = (xp[:, di:di + h, dj:dj + wd] * g32).sum((0, 1, 2))
    return acc.to(x.dtype), dw, g32.sum((0, 1, 2))


def _check_cuda(x: torch.Tensor, ksize: int, kernel: str,
                *others: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if ksize != CUDA_KSIZE:
        raise NotImplementedError(f"{kernel} is built for k = {CUDA_KSIZE}, "
                                  f"got {ksize}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{kernel} takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] % 8:
        raise NotImplementedError(f"{kernel} takes (N, H, W, C) with C a "
                                  f"multiple of 8, got {tuple(x.shape)}")
    for t in (x, *others):
        if (t.dtype != x.dtype or t.shape != x.shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{kernel} takes contiguous, 16-byte aligned "
                             f"{tuple(x.shape)} {x.dtype} tensors, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _shapes(x, w, b=None) -> None:
    k, c = w.shape[0], x.shape[-1]
    if tuple(w.shape) != (k, k, c) or (b is not None and tuple(b.shape) != (c,)):
        raise ValueError(f"w must be (k, k, {c}) and b ({c},), got "
                         f"{tuple(w.shape)} and "
                         f"{None if b is None else tuple(b.shape)}")


def depthwise_fwd(x, w, b, ksize: int = 7):
    """K11a: y = depthwise(x, w) + b, SAME padding, channels-last."""
    _shapes(x, w, b)
    if x.device.type == "cpu":
        return depthwise_fwd_ref(x, w, b, ksize)
    _check_cuda(x, ksize, "K11a")
    n, h, wd, c = x.shape
    w = _build.cuda_arg(w, x, "w", x.dtype)
    b = _build.cuda_arg(b, x, "b", x.dtype)
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.depthwise_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                y.data_ptr(), n, h, wd, c,
                                int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "depthwise_fwd")
    global launches
    launches += 1
    return y


def depthwise_bwd(x, g, w, ksize: int = 7):
    """K11b: (dx, dw fp32, db fp32) from the output gradient g."""
    _shapes(x, w)
    if x.device.type == "cpu":
        return depthwise_bwd_ref(x, g, w, ksize)
    _check_cuda(x, ksize, "K11b", g)
    n, h, wd, c = x.shape
    wf = _build.cuda_arg(w.flip(0, 1), x, "w", x.dtype)
    dx = torch.empty_like(x)
    dw = torch.zeros(ksize, ksize, c, device=x.device)
    db = torch.zeros(c, device=x.device)
    lib = _build.load()
    # fp32 partial sums of (dw, db) per block row, added in a fixed order
    part = torch.empty(lib.depthwise_bwd_parts(n, h, wd), ksize * ksize + 1,
                       c, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.depthwise_bwd(x.data_ptr(), g.data_ptr(), wf.data_ptr(),
                                dx.data_ptr(), part.data_ptr(), dw.data_ptr(),
                                db.data_ptr(), n, h, wd, c,
                                int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "depthwise_bwd")
    global bwd_launches
    bwd_launches += 1
    return dx, dw, db


class DepthwiseConv(torch.autograd.Function):
    """(x, w, b) → y through K11a; the backward runs K11b once and hands dx,
    dw and db on where they are asked for, dw and db in w's dtype
    (``_dw_bwd``, :158). Both kernels are looked up in this module when
    called, so a caller can route them elsewhere."""

    @staticmethod
    def forward(ctx, x, w, b, ksize):
        ctx.save_for_backward(x, w)
        ctx.ksize = ksize
        return depthwise_fwd(x, w, b, ksize)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        if not any(need[:3]):
            return None, None, None, None
        dx, dw, db = depthwise_bwd(x, g.contiguous(), w, ctx.ksize)
        return (dx if need[0] else None, dw.to(w.dtype) if need[1] else None,
                db.to(w.dtype) if need[2] else None, None)


def depthwise_conv(x, w, b, ksize: int = 7) -> torch.Tensor:
    """SAME-padded depthwise conv: x (N, H, W, C), w (k, k, C), b (C,) →
    (N, H, W, C) in x's dtype."""
    return DepthwiseConv.apply(x, w, b, ksize)
