"""K9a, K9b and K9c: the non-affine LayerNorm fused into the product that
follows it, and the two passes of its backward (CUDA C++,
``csrc/ln_matmul.cu`` and ``csrc/ln_bwd.cu``).

K9a replaces the Pallas kernel ``vit_tpu/kernels/ln_matmul.py:_fwd_kernel``
(:60, launched by ``_fwd_impl`` :121) behind ``fused_ln_matmul`` (:359). From
the raw residual stream x (N, C) it computes the LayerNorm statistics (fp32,
two passes: the mean, then the mean of squared deviations; eps 1e-5), x̂
rounded to the compute dtype, and z = x̂·Wᵀ (+ b) with an fp32 sum; the bias
is rounded to the compute dtype and added in fp32. At the fc1 site it writes
zpre (the fp32 sum rounded once) and z = GELU of the fp32 sum. With a
gradient to track it also writes x̂ for the backward; without one it writes z
alone.

K9b replaces ``_dgelu_kernel`` (:148, launched by ``_dgelu_impl`` :166):
dzc = dz ⊙ gelu′(zpre) in one pass. K9c replaces ``_ln_bwd_kernel`` (:78,
launched by ``_ln_bwd_impl`` :190): dx = rstd·(g − mean(g) − x̂·mean(g·x̂)),
with x̂ and rstd recomputed from x in fp32.

The GELU inside K9a and K9b is always the tanh-composed erf and its flat
derivative (``vit_tpu/kernels/convnext_block.py:_gelu``, ``_gelu_grad``),
whatever ``gelu_impl`` or ``$VIT_TPU_GELU`` asks for: a quirk of the JAX
package that the port keeps.

What bounds them on the H100: K9a is a product, 2·N·C·F FLOP against
N·C + C·F + N·F bf16 values (+ N·F for zpre and N·C for x̂), about 300 FLOP
per byte at the flagship's widths, at the card's bf16 ridge; K9b and K9c are
single passes over bf16 rows, bound by bytes. The sources' headers give the
designs.

:class:`FusedLnMatmul` is the autograd Function (``_lnmm_fwd``/``_lnmm_bwd``,
:330-353) and :func:`fused_ln_matmul` the entry. Weights are taken in
PyTorch's Linear layout, W (F, C). Each wrapper launches its kernel for a
CUDA tensor or raises, and runs its plain PyTorch version (``*_ref``) for a
CPU tensor. The JAX module's ``_flat3``/``custom_partitioning`` code (GSPMD
partitioning) has no counterpart here.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.kernels import _build
from vit_tpu_torch.ops.gelu import gelu_grad, tanh_erf_gelu

LANE = 128            # the JAX gate: C and F multiples of 128
MAX_CUDA_DIM = 1024   # K9a and K9c keep whole rows on chip: C ≤ 1024 (L)
EPS = 1e-5            # core.transformer.LayerNorm's

launches = 0          # K9a launches by ln_matmul_fwd, for run evidence
dgelu_launches = 0    # K9b launches by ln_matmul_dgelu
ln_bwd_launches = 0   # K9c launches by ln_bwd


def supported(c: int, f: int) -> bool:
    """The JAX package's gate (``ln_matmul.supported``)."""
    return c % LANE == 0 and f % LANE == 0


def _stats(x32: torch.Tensor):
    """Two-pass fp32 row statistics → (x̂, rstd), as ``_stats`` (:52)."""
    mu = x32.mean(-1, keepdim=True)
    d = x32 - mu
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + EPS)
    return d * rstd, rstd


def ln_matmul_fwd_ref(x, w, b=None, gelu: bool = False,
                      residuals: bool = True):
    """Plain version of K9a: x (N, C), w (F, C), b (F,) or None → (z,
    zpre, x̂), zpre None without ``gelu``; zpre and x̂ None without
    ``residuals``. The same rounding points as the kernel."""
    dt = x.dtype
    xhat32, _ = _stats(x.float())
    u = xhat32.to(dt)
    acc = u.float() @ w.to(dt).float().t()
    if b is not None:
        acc = acc + b.to(dt).float()
    zpre = None
    if gelu:
        zpre = acc.to(dt)
        acc = tanh_erf_gelu(acc)
    if not residuals:
        return acc.to(dt), None, None
    return acc.to(dt), zpre, u


def ln_matmul_dgelu_ref(zpre: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """Plain version of K9b: dz ⊙ gelu′(zpre) in fp32, in dz's dtype."""
    return (dz.float() * gelu_grad(zpre.float())).to(dz.dtype)


def ln_bwd_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K9c: the non-affine LN's input gradient from the
    gradient g of x̂, statistics recomputed; in x's dtype."""
    xhat, rstd = _stats(x.float())
    g32 = g.float()
    c1 = g32.mean(-1, keepdim=True)
    c2 = (g32 * xhat).mean(-1, keepdim=True)
    return (rstd * (g32 - c1 - xhat * c2)).to(x.dtype)


def _check_width(c: int, kernel: str) -> None:
    if c % LANE or c > MAX_CUDA_DIM:
        raise NotImplementedError(f"{kernel} takes C a multiple of {LANE} up "
                                  f"to {MAX_CUDA_DIM}, got {c}")


def ln_matmul_fwd(x: torch.Tensor, w: torch.Tensor,
                  b: "torch.Tensor | None" = None, gelu: bool = False,
                  residuals: bool = True):
    """K9a: x (N, C), w (F, C), b (F,) or None → (z (N, F), zpre (N, F) or
    None, x̂ (N, C) or None), all in x's dtype; zpre only with ``gelu``, zpre
    and x̂ only with ``residuals``. A CUDA tensor launches the kernel (bf16,
    C a multiple of 128 up to 1024, F a multiple of 128) or raises; a CPU
    tensor runs the plain version."""
    n, c = x.shape
    f = w.shape[0]
    if w.shape != (f, c) or (b is not None and b.shape != (f,)):
        raise ValueError(f"w {tuple(w.shape)} and b "
                         f"{None if b is None else tuple(b.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ln_matmul_fwd_ref(x, w, b, gelu, residuals)
    _build.check_rows(x, "K9a", "x")
    _check_width(c, "K9a")
    if f % LANE:
        raise NotImplementedError(f"K9a takes F a multiple of {LANE}, got {f}")
    w = _build.cuda_arg(w, x, "w", torch.bfloat16)
    b = None if b is None else _build.cuda_arg(b, x, "b", torch.bfloat16)
    z = torch.empty(n, f, dtype=torch.bfloat16, device=x.device)
    zpre = torch.empty_like(z) if gelu and residuals else None
    xhat = torch.empty_like(x) if residuals else None
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ln_matmul_fwd(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            z.data_ptr(), None if zpre is None else zpre.data_ptr(),
            None if xhat is None else xhat.data_ptr(), n, c, f, int(gelu),
            stream)
    _build.check(lib, err, "ln_matmul_fwd")
    global launches
    launches += 1
    return z, zpre, xhat


def ln_matmul_dgelu(zpre: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """K9b: dzc = dz ⊙ gelu′(zpre) over (N, F). A CUDA tensor launches the
    kernel (bf16) or raises; a CPU tensor runs the plain version."""
    if zpre.shape != dz.shape:
        raise ValueError(f"zpre {tuple(zpre.shape)} and dz "
                         f"{tuple(dz.shape)} differ")
    if zpre.device.type == "cpu":
        return ln_matmul_dgelu_ref(zpre, dz)
    _build.check_rows(zpre, "K9b", "zpre")
    _build.check_rows(dz, "K9b", "dz")
    dzc = torch.empty_like(dz)
    lib = _build.load()
    with torch.cuda.device(dz.device):
        stream = torch.cuda.current_stream(dz.device).cuda_stream
        err = lib.ln_matmul_dgelu(zpre.data_ptr(), dz.data_ptr(),
                                  dzc.data_ptr(), dz.numel(), stream)
    _build.check(lib, err, "ln_matmul_dgelu")
    global dgelu_launches
    dgelu_launches += 1
    return dzc


def ln_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K9c: dx (N, C) in x's dtype from x and the gradient g of x̂. A CUDA
    tensor launches the kernel (bf16, C a multiple of 128 up to 1024) or
    raises; a CPU tensor runs the plain version."""
    if x.shape != g.shape:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} differ")
    if x.device.type == "cpu":
        return ln_bwd_ref(x, g)
    _build.check_rows(x, "K9c", "x")
    _build.check_rows(g, "K9c", "g")
    n, c = x.shape
    _check_width(c, "K9c")
    dx = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ln_bwd(x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, c,
                         stream)
    _build.check(lib, err, "ln_bwd")
    global ln_bwd_launches
    ln_bwd_launches += 1
    return dx


class FusedLnMatmul(torch.autograd.Function):
    """(x (N, C), w (F, C), b or None, gelu) → z (N, F), as ``_lnmm_fwd`` /
    ``_lnmm_bwd``. The backward: dzc = K9b(zpre, dz) at the GELU site, dW =
    dzcᵀ·x̂ and dx̂ = dzc·W as plain products (the JAX package leaves them to
    XLA; a bf16 product sums in fp32 and rounds once, as JAX's fp32 result
    cast to the weight's and x's dtype), dx = K9c(x, dx̂) and db = Σ dzc in
    fp32. The kernels are looked up in this module when called, so a caller
    can route them elsewhere (``chip_smoke.py``'s plain-version run does)."""

    @staticmethod
    def forward(ctx, x, w, b, gelu):
        z, zpre, xhat = ln_matmul_fwd(x, w, b, gelu)
        ctx.save_for_backward(x, w, zpre, xhat)
        ctx.gelu, ctx.has_bias = gelu, b is not None
        return z

    @staticmethod
    def backward(ctx, dz):
        x, w, zpre, xhat = ctx.saved_tensors
        dz = dz.contiguous()
        dzc = ln_matmul_dgelu(zpre, dz) if ctx.gelu else dz
        dw = (dzc.t() @ xhat).to(w.dtype)
        dxhat = (dzc @ w).to(x.dtype)
        dx = ln_bwd(x, dxhat)
        db = dzc.sum(0, dtype=torch.float32).to(w.dtype) if ctx.has_bias \
            else None
        return dx, dw, db, None


def fused_ln_matmul(x: torch.Tensor, w: torch.Tensor,
                    b: "torch.Tensor | None" = None, *,
                    gelu: bool = False) -> torch.Tensor:
    """z = [gelu](LN(x)·Wᵀ [+ b]) with the non-affine fp32-statistics
    LayerNorm fused into the product. x (..., C) in the compute dtype, w
    (F, C) and b (F,) cast to it by the caller. The caller checks
    ``supported(C, F)``. Without a gradient to track K9a runs alone and
    writes neither zpre nor x̂."""
    lead, c = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, c)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        z = FusedLnMatmul.apply(x2.contiguous(), w, b, gelu)
    else:
        z = ln_matmul_fwd(x2.contiguous(), w, b, gelu, residuals=False)[0]
    return z.reshape(*lead, w.shape[0])
