"""K10: a linear layer's weight and bias gradients in one pass over the
upstream gradient (CUDA C++, ``csrc/fc_grad.cu``).

K10 replaces the Pallas kernel ``vit_tpu/kernels/fc_grad.py:_fc_grad_kernel``
(:74, launched by ``matmul_dw_db`` :145) behind ``fused_dense`` (:237). The
port's weights are (out, in), so for fc1 and fc2 alike the weight gradient
is dW = gᵀ·x (F_out, F_in) and the bias gradient db = Σₙ g, both fp32, from
g (N, F_out) and x (N, F_in): the JAX package's fc2 arrangement (:263). The
column sum reads the g tiles the product already holds in shared memory, so
g is read once for both. The TPU's layout levers (``db_operand``,
``$VIT_TPU_FC_GRAD_T``) have no counterpart.

What bounds it on the H100: 2·N·F_out·F_in FLOP against (N·(F_out + F_in))
bf16 values read and F_out·F_in fp32 written, about 600 FLOP per byte at
the flagship's widths: the tensor cores. bf16 operands launch
``fc_grad_bf16_kernel``: TMA-fed wgmma on 128 × 256 dW tiles, N cut
into :func:`splits_bf16` parts whose partials the last block of each tile
adds into dW in split order (a count a tile, kept zeroed between calls by
``_build.zeroed``). The source's header gives the design.

:class:`FusedDense` is the autograd Function (``_fd_fwd``/``_fd_bwd``,
:249-265) and :func:`fused_dense` the entry. The wrapper launches the kernel
for a CUDA tensor or raises, and runs its plain PyTorch version for a CPU
tensor. fp32 operands launch the fp32 form (``fc_grad_f32``: dW as six
bf16 wgmma products of three bf16 parts of each operand, split in the
kernel; db from the fp32 g), counted apart in ``fp32_launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_tpu_torch.kernels import _build

LANE = 128
ACC_BUDGET = 4 * 1024 * 1024   # the JAX gate's fp32 dW block budget (bytes)
TILE = 128                     # K10's output tile rows (F_out)
BN_BF16 = 256                  # the bf16 form's tile columns (kBN1)
# A wave of the bf16 form's blocks costs about as much as this many more
# rows of N a split (its time against the split count, H100, PERF.md §6)
WAVE_ROWS = 1024

launches = 0   # K10 launches by matmul_dw_db, for run evidence
fp32_launches = 0   # of those, the launches of the fp32 form


def supported(ca: int, k: int) -> bool:
    """The JAX package's gate (``fc_grad.supported``)."""
    return ca % LANE == 0 and k % LANE == 0 and ca * 4 * LANE <= ACC_BUDGET


def fused_dense_supported(cin: int, cout: int) -> bool:
    """The JAX package's gate (``fc_grad.fused_dense_supported``)."""
    return supported(min(cin, cout), max(cin, cout))


def matmul_dw_db_ref(g: torch.Tensor, x: torch.Tensor):
    """Plain version of K10: g (N, F_out), x (N, F_in) → (gᵀ·x, Σₙ g), both
    fp32 (an fp32 product of the operands as given)."""
    g32 = g.float()
    return g32.t() @ x.float(), g32.sum(0)


def splits_f32(n: int, tiles: int, sms: int, most: int = 16) -> int:
    """How many parts the fp32 form cuts the contraction over N into: its
    blocks hold a whole SM each (230 KB of shared memory), so the count s
    of at most ``most`` parts (and one per 8 atoms of 32 rows) whose waves,
    ceil(tiles·s / sms), cost least for each part, the first such s (fc1's
    and fc2's 144 tiles on 132 SMs: 11 parts, 12 full waves)."""
    best, cost = 1, None
    for s in range(1, max(1, min(most, -(-n // 256))) + 1):
        c = -(-tiles * s // sms) / s
        if cost is None or c < cost - 1e-12:
            best, cost = s, c
    return best


def tiles_bf16(fo: int, fi: int) -> int:
    """The bf16 form's dW tiles: 128 rows × BN_BF16 columns."""
    return (fo // TILE) * -(-fi // BN_BF16)


def splits_bf16(n: int, tiles: int, sms: int) -> int:
    """How many parts the bf16 form cuts N into: its blocks hold an SM each
    (the ring's 192 KB), and a wave of them costs its rows plus a fixed
    WAVE_ROWS (the ring's fill, the epilogue, the splits' ordered sum), so
    the count s of at most 16 parts (and one per 256 rows) that
    minimises ceil(tiles·s / sms)·(ceil(n / s) + WAVE_ROWS), the first such
    s (fc1's and fc2's 72 tiles of 128 × 256 over N 20480 on 132 SMs: 5
    parts in 3 waves)."""
    best, cost = 1, None
    for s in range(1, max(1, min(16, -(-n // 256))) + 1):
        c = -(-tiles * s // sms) * (-(-n // s) + WAVE_ROWS)
        if cost is None or c < cost:
            best, cost = s, c
    return best


def matmul_dw_db(g: torch.Tensor, x: torch.Tensor):
    """K10: g (N, F_out), x (N, F_in) → (dW (F_out, F_in), db (F_out,)),
    fp32. A CUDA tensor launches the kernel (bf16 or fp32 operands of one
    dtype, both widths multiples of 128) or raises; a CPU tensor runs the
    plain version."""
    if g.dim() != 2 or x.dim() != 2 or g.shape[0] != x.shape[0]:
        raise ValueError(f"g {tuple(g.shape)} and x {tuple(x.shape)} must be "
                         "(N, F_out) and (N, F_in)")
    if g.device.type == "cpu":
        return matmul_dw_db_ref(g, x)
    _build.compute_dtype("K10", g, x)
    _build.check_rows(g, "K10", "g")
    _build.check_rows(x, "K10", "x")
    if x.device != g.device:
        raise ValueError(f"g on {g.device}, x on {x.device}")
    n, fo = g.shape
    fi = x.shape[1]
    if fo % TILE or fi % TILE:
        raise NotImplementedError(f"K10 takes widths that are multiples of "
                                  f"{TILE}, got {fo} and {fi}")
    dw = torch.empty(fo, fi, dtype=torch.float32, device=g.device)
    db = torch.empty(fo, dtype=torch.float32, device=g.device)
    f32 = g.dtype == torch.float32
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    lib = _build.load()
    tiles = (fo // TILE) * (fi // TILE) if f32 else tiles_bf16(fo, fi)
    splits = (splits_f32 if f32 else splits_bf16)(n, tiles, sms)
    args = (None, None)
    if splits > 1:   # fp32 partial sums, added in a fixed order
        part = torch.empty(splits, fo, fi, dtype=torch.float32,
                           device=g.device)
        part_db = torch.empty(splits, fo, dtype=torch.float32,
                              device=g.device)
        args = (part.data_ptr(), part_db.data_ptr())
    if not f32:
        # a count a dW tile: its last split adds the partials in the
        # kernel, and leaves the counts zero
        counts = (_build.zeroed("fc_grad", tiles, torch.int32, g.device)
                  if splits > 1 else None)
        args += (None if counts is None else counts.data_ptr(),)
    args += (n, fo, fi, splits)
    entry = "fc_grad_f32" if f32 else "fc_grad"
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = getattr(lib, entry)(
            g.data_ptr(), x.data_ptr(), dw.data_ptr(), db.data_ptr(), *args,
            stream)
    _build.check(lib, err, entry)
    global launches, fp32_launches
    launches += 1
    fp32_launches += f32
    return dw, db


class FusedDense(torch.autograd.Function):
    """(x (..., F_in), w (F_out, F_in), b (F_out,)) → x·Wᵀ + b, the product
    rounded to the compute dtype before the bias is added in it, as
    ``jnp.dot(x, kernel) + bias``. The backward: dx = g·W as a plain
    product, then (dW, db) from K10 in one pass over g, dW cast to w's dtype
    and db to g's (``_fd_bwd``). K10 is looked up in this module when
    called, so a caller can route it elsewhere."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.linear(x, w) + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = g @ w
        dw, db = matmul_dw_db(g.reshape(-1, g.shape[-1]).contiguous(),
                              x.reshape(-1, x.shape[-1]).contiguous())
        return dx, dw.to(w.dtype), db.to(g.dtype)


def fused_dense(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """y = x·Wᵀ + b with the fused dW+db backward; x, w (F_out, F_in) and b
    in the compute dtype (the caller casts the parameters). The caller
    checks ``fused_dense_supported``."""
    return FusedDense.apply(x, w, b)
