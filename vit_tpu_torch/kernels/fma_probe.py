"""P: the FMA-rate probe (CUDA C++, ``csrc/fma_probe.cu``).

Replaces the Pallas kernel ``scripts/bench_vpu.py:_fma_kernel`` (:32,
launched by ``vpu_fma_rate`` :53 through ``pl.pallas_call`` :60), which
measured the TPU vector unit's fp32 FMA ceiling. On the H100 it measures the
CUDA cores' fp32 (and bf16) FMA rate: the ceiling of the port's fp32 kernel
forms and of any work the tensor cores cannot take, such as the 7×7
depthwise convolutions.

:func:`fma_chains` is the kernel's wrapper, :func:`fma_chains_ref` its plain
version and :func:`fma_rate` the measurement. Every element x carries
``chains`` independent streams aᵢ = x + i; each runs ``iters`` steps of
a ← a·c + d with c = 1.0000001 and d = 1e-7 in the element type, and the
output is Σᵢ aᵢ, added in order in the element type. The kernel takes each
step as one fused multiply-add (one rounding); the plain version forms a·c
+ d exactly in float64 and rounds it to the element type, the same value
for the magnitudes the probe checks (a below 2⁵: the exact sum spans at
most 53 bits). In bf16, c rounds to 1 and d lies below half an ulp of
every a ≥ 1, so each step returns a: at the script's constants the bf16
output is Σᵢ (x + i) whether the steps run or not. ``c`` and ``d`` may be
given in their place (the kernel takes both as arguments), as a check that
the bf16 steps run does: in bf16, c = 1 + 2⁻⁷ and d = 2⁻¹⁰ change a at every
step, and a·c + d stays exact in float64 while a < 2⁶. The default shape
fills the card: 132 SMs × 2,048 resident threads, one fp32 element or one
bf16 pair a thread.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vit_tpu_torch.kernels import _build

C_STEP, D_STEP = 1.0000001, 1e-7   # the step's constants (_fma_kernel)
MAX_CHAINS = 6
SMS, THREADS_PER_SM = 132, 2048
LANES = 128   # row width, the lanes of the TPU kernel's (64, 128) block

launches = 0   # P launches by fma_chains, for run evidence


def default_shape(dtype: torch.dtype) -> "tuple[int, int]":
    """The card-filling shape: one element (fp32) or pair (bf16) for each
    of 132 × 2,048 threads, as rows of 128."""
    per_thread = 2 if dtype == torch.bfloat16 else 1
    return SMS * THREADS_PER_SM * per_thread // LANES, LANES


def _consts(dtype: torch.dtype, c: float,
            d: float) -> "tuple[float, float]":
    """c and d rounded to ``dtype``, as ``jnp.asarray(·, x.dtype)``."""
    c, d = torch.tensor([c, d], dtype=torch.float64).to(dtype)
    return float(c), float(d)


def _check(x: torch.Tensor, iters: int, chains: int) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"P takes fp32 or bf16, got {x.dtype}")
    if not 1 <= chains <= MAX_CHAINS:
        raise ValueError(f"chains must lie in 1..{MAX_CHAINS}, got {chains}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def fma_chains_ref(x: torch.Tensor, iters: int, chains: int,
                   c: float = C_STEP, d: float = D_STEP) -> torch.Tensor:
    """Plain version of P: Σᵢ aᵢ after ``iters`` steps of aᵢ ← aᵢ·c + d from
    aᵢ = x + i, each step rounded once to x's dtype, the sum added in order
    in x's dtype."""
    _check(x, iters, chains)
    dt = x.dtype
    c, d = _consts(dt, c, d)
    accs = [(x + i).to(dt) for i in range(chains)]
    for _ in range(iters):
        accs = [(a.double() * c + d).to(dt) for a in accs]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def fma_chains(x: torch.Tensor, iters: int, chains: int,
               c: float = C_STEP, d: float = D_STEP) -> torch.Tensor:
    """P: the probe's function over every element of x (fp32, or bf16 with
    an even count). A CUDA tensor launches the kernel or raises; a CPU
    tensor runs the plain version."""
    _check(x, iters, chains)
    if x.device.type == "cpu":
        return fma_chains_ref(x, iters, chains, c, d)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("P takes a contiguous, 16-byte aligned tensor")
    if x.dtype == torch.bfloat16 and x.numel() % 2:
        raise ValueError("P takes bf16 elements in pairs: an even count")
    out = torch.empty_like(x)
    c, d = _consts(x.dtype, c, d)
    entry = "fma_chains_f32" if x.dtype == torch.float32 else "fma_chains_bf16"
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), x.numel(),
                                  iters, chains, c, d, stream)
    _build.check(lib, err, entry)
    global launches
    launches += 1
    return out


def macs(shape, iters: int, chains: int) -> int:
    """Multiply-adds of one call: every element, every chain, every step."""
    return int(np.prod(shape)) * iters * chains


def fma_rate(shape=None, iters: int = 4096, steps: int = 20,
             dtype: torch.dtype = torch.float32, chains: int = 1,
             device: "str | torch.device" = "cuda"):
    """(MAC/s, seconds per call) of P over ``shape`` (the card-filling
    default when None), each call fed the previous one's output, as
    ``vpu_fma_rate`` does: CUDA events around ``steps`` calls after one
    warm-up on a card; the host clock on the CPU, where the plain version
    runs and the figure is the CPU's."""
    device = torch.device(device)
    shape = default_shape(dtype) if shape is None else tuple(shape)
    out = fma_chains(torch.ones(shape, dtype=dtype, device=device), iters,
                     chains)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(steps):
            out = fma_chains(out, iters, chains)
        end.record()
        torch.cuda.synchronize(device)
        dt = start.elapsed_time(end) / 1e3 / steps
    else:
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fma_chains(out, iters, chains)
        dt = (time.perf_counter() - t0) / steps
    return macs(shape, iters, chains) / dt, dt
