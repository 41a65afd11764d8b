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
the flagship's widths: the tensor cores. The source's header gives the
design.

:class:`FusedDense` is the autograd Function (``_fd_fwd``/``_fd_bwd``,
:249-265) and :func:`fused_dense` the entry. The wrapper launches the kernel
for a CUDA tensor or raises, and runs its plain PyTorch version for a CPU
tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_tpu_torch.kernels import _build

LANE = 128
ACC_BUDGET = 4 * 1024 * 1024   # the JAX gate's fp32 dW block budget (bytes)
TILE = 128                     # K10's output tile, both sides
CHUNK = 32                     # rows of N per pipeline stage

launches = 0   # K10 launches by matmul_dw_db, for run evidence


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


def _splits(n: int, tiles: int, device: torch.device) -> int:
    """How many parts the contraction over N is cut into: enough blocks for
    about four per SM when the output alone has fewer tiles (fc1's and
    fc2's 6 × 24 on 132 SMs), never more parts than chunks of N."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-4 * sms // tiles)
    return max(1, min(want, -(-n // (4 * CHUNK))))


def matmul_dw_db(g: torch.Tensor, x: torch.Tensor):
    """K10: g (N, F_out), x (N, F_in) → (dW (F_out, F_in), db (F_out,)),
    fp32. A CUDA tensor launches the kernel (bf16, both widths multiples of
    128) or raises; a CPU tensor runs the plain version."""
    if g.dim() != 2 or x.dim() != 2 or g.shape[0] != x.shape[0]:
        raise ValueError(f"g {tuple(g.shape)} and x {tuple(x.shape)} must be "
                         "(N, F_out) and (N, F_in)")
    if g.device.type == "cpu":
        return matmul_dw_db_ref(g, x)
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
    splits = _splits(n, (fo // TILE) * (fi // TILE), g.device)
    part = part_db = None
    if splits > 1:   # fp32 partial sums, reduced in a fixed order
        part = torch.empty(splits, fo, fi, dtype=torch.float32,
                           device=g.device)
        part_db = torch.empty(splits, fo, dtype=torch.float32,
                              device=g.device)
    lib = _build.load()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.fc_grad(
            g.data_ptr(), x.data_ptr(), dw.data_ptr(), db.data_ptr(),
            None if part is None else part.data_ptr(),
            None if part_db is None else part_db.data_ptr(), n, fo, fi,
            splits, stream)
    _build.check(lib, err, "fc_grad")
    global launches
    launches += 1
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
