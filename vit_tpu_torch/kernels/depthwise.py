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
(4·k² for K11b's full form) against one read of x and one write of y (3
tensors for K11b): at k 7 the bytes and the fp32 rate give about the same
bound. The TPU kernel holds one halo-padded image in VMEM; here a thread
owns a 7 × 7 patch of one channel, and a block takes a tile of up to 2 × 2
patches of 32 channels (of several 7 × 7 images at ConvNeXt-S's last
stage) by one TMA box whose halo the hardware zero-fills, and writes its
outputs by one TMA store, walking tiles through a 2-stage ring (see the
source's header). The C launcher chooses the tiles and the walk for each
shape from the card's SM count and occupancy; :func:`tile_plan` reads that
choice.

K11b has two forms: the full one (dx, dw, db) and a dx-only one, which the
autograd Function launches when no weight gradient is asked for (the frozen
perceptual trunk). Both compute dx with the same code, so their dx are the
same bits; the plain version has both forms too.

The lax path (``losses/perceptual.py``'s ``F.conv2d``) rounds the
convolution before it adds the bias; these kernels and their plain versions
follow the Pallas kernel, so the two differ in bf16.

Each wrapper launches its kernel for a CUDA tensor (bf16 or fp32, C a
multiple of 8, k = 7) or raises, and runs its plain PyTorch version for a
CPU tensor.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from vit_tpu_torch.kernels import _build

CUDA_KSIZE = 7   # the tap count the CUDA kernels are built for
# depthwise_plan's fields
PLAN_FIELDS = ("tr", "tc", "ti", "own_box", "warps", "walkers", "tiles",
               "smem", "blocks_per_sm")

launches = 0          # K11a launches by depthwise_fwd, for run evidence
bwd_launches = 0      # K11b launches by depthwise_bwd, both forms
dx_only_launches = 0  # those of them in the dx-only form


@functools.lru_cache(maxsize=None)
def tile_plan(n: int, h: int, w: int, c: int, bf16: bool, form: int,
              device: int) -> dict:
    """The tile plan ``csrc/depthwise.cu:choose_plan`` launches form ``form``
    (0: K11a, 1: the dx-only K11b, 2: the full K11b) with at (n, h, w, c) in
    bf16 or fp32 on card ``device``: a tile of tr × tc patches of 7 × 7
    outputs of ti images, one warp a patch, with an output box of its own
    or not, the kernel's shared memory and blocks an SM, and ``walkers``
    blocks a 32-channel group. The full form's partial rows are sized by
    its walkers."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.depthwise_plan(n, h, w, c, int(bf16), form, out)
    _build.check(lib, err, "depthwise_plan")
    return dict(zip(PLAN_FIELDS, out))


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


def depthwise_bwd_ref(x, g, w, ksize: int = 7, dx_only: bool = False):
    """Plain version of K11b (``_dw_bwd_kernel``): (dx in x's dtype,
    dw (k, k, C) fp32, db (C,) fp32); with ``dx_only``, (dx, None, None),
    dx by the same code."""
    n, h, wd, c = x.shape
    p = ksize // 2
    gp, g32 = _pad(g, p), g.float()
    wf = w.flip(0, 1).float()
    acc = torch.zeros_like(g32)
    for di in range(ksize):
        for dj in range(ksize):
            acc = acc + gp[:, di:di + h, dj:dj + wd] * wf[di, dj]
    if dx_only:
        return acc.to(x.dtype), None, None
    xp = _pad(x, p)
    dw = torch.empty(ksize, ksize, c, device=x.device)
    for di in range(ksize):
        for dj in range(ksize):
            dw[di, dj] = (xp[:, di:di + h, dj:dj + wd] * g32).sum((0, 1, 2))
    return acc.to(x.dtype), dw, g32.sum((0, 1, 2))


def _check_cuda(x: torch.Tensor, ksize: int, kernel: str,
                *others: torch.Tensor) -> None:
    if not x.is_cuda:
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
    if w.shape != (k, k, c) or (b is not None and b.shape != (c,)):
        raise ValueError(f"w must be (k, k, {c}) and b ({c},), got "
                         f"{tuple(w.shape)} and "
                         f"{None if b is None else tuple(b.shape)}")


def _taps(t: torch.Tensor, x: torch.Tensor, name: str) -> torch.Tensor:
    """w or b as the kernels read them (``_build.cuda_arg``), passed as it
    is where it already is so: that check costs a fraction of the copy's
    host time, and the wrappers' host time sets the small stages' calls."""
    if (t.dtype == x.dtype and t.get_device() == x.get_device()
            and t.is_contiguous() and t.data_ptr() % 16 == 0):
        return t
    return _build.cuda_arg(t, x, name, x.dtype)


def _on_device(x: torch.Tensor):
    """The C launcher runs on the current device: x's, switched to only
    where it is another (the switch costs host time on every call)."""
    if x.get_device() == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def _stream(x: torch.Tensor) -> int:
    """The current stream of x's device, as the C launcher takes it: the
    raw handle (``torch.cuda.current_stream()`` builds a Stream object on
    every call, a large share of a small stage's host-bound call)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def depthwise_fwd(x, w, b, ksize: int = 7):
    """K11a: y = depthwise(x, w) + b, SAME padding, channels-last."""
    _shapes(x, w, b)
    if x.is_cpu:
        return depthwise_fwd_ref(x, w, b, ksize)
    _check_cuda(x, ksize, "K11a")
    n, h, wd, c = x.shape
    w, b = _taps(w, x, "w"), _taps(b, x, "b")
    y = torch.empty_like(x)
    lib = _build.load()
    with _on_device(x):
        err = lib.depthwise_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                y.data_ptr(), n, h, wd, c,
                                int(x.dtype == torch.bfloat16), _stream(x))
    _build.check(lib, err, "depthwise_fwd")
    global launches
    launches += 1
    return y


def depthwise_bwd(x, g, w, ksize: int = 7, dx_only: bool = False):
    """K11b: (dx, dw fp32, db fp32) from the output gradient g; with
    ``dx_only`` the dx-only form, (dx, None, None)."""
    _shapes(x, w)
    if x.is_cpu:
        return depthwise_bwd_ref(x, g, w, ksize, dx_only)
    _check_cuda(x, ksize, "K11b", g)
    n, h, wd, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    w = _taps(w, x, "w")   # the kernel flips the taps
    dx = torch.empty_like(x)
    if dx_only:
        dw = db = part = None
        rows = 0
    else:
        dw = torch.empty(ksize, ksize, c, device=x.device)
        db = torch.empty(c, device=x.device)
        # fp32 partial sums of (dw, db), one row a walker, added in order
        rows = tile_plan(n, h, wd, c, bf16, 2, x.get_device())["walkers"]
        part = torch.empty(rows, ksize * ksize + 1, c, device=x.device)
    lib = _build.load()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with _on_device(x):
        err = lib.depthwise_bwd(None if dx_only else x.data_ptr(),
                                g.data_ptr(), w.data_ptr(), dx.data_ptr(),
                                ptr(part), ptr(dw), ptr(db), n, h, wd, c,
                                int(bf16), rows, _stream(x))
    _build.check(lib, err, "depthwise_bwd")
    global bwd_launches, dx_only_launches
    bwd_launches += 1
    dx_only_launches += int(dx_only)
    return dx, dw, db


class DepthwiseConv(torch.autograd.Function):
    """(x, w, b) → y through K11a; the backward runs K11b once and hands dx,
    dw and db on where they are asked for, dw and db in w's dtype
    (``_dw_bwd``, :158): its dx-only form where neither w nor b needs a
    gradient (a frozen net), else the full form. Both kernels are looked up
    in this module when called, so a caller can route them elsewhere."""

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
        dx, dw, db = depthwise_bwd(x, g.contiguous(), w, ctx.ksize,
                                   dx_only=not (need[1] or need[2]))
        return (dx if need[0] else None, dw.to(w.dtype) if need[1] else None,
                db.to(w.dtype) if need[2] else None, None)


def depthwise_conv(x, w, b, ksize: int = 7) -> torch.Tensor:
    """SAME-padded depthwise conv: x (N, H, W, C), w (k, k, C), b (C,) →
    (N, H, W, C) in x's dtype."""
    return DepthwiseConv.apply(x, w, b, ksize)
