"""Attention kernels: K1 and K2, packed-QKV attention forward and backward
(CUDA C++, ``csrc/attention_packed_fwd.cu`` and ``csrc/attention_packed_bwd.cu``),
and K6 with K7/K8, unpacked attention forward and backward
(``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``).

K1 replaces the Pallas kernel ``vit_tpu/kernels/attention.py:_fa_packed_kernel``
(:623), launched by ``_packed_fwd_impl`` (:790) behind
``flash_attention_packed`` (:1269): softmax(q kᵀ/√d)·v straight off the
unbiased packed projection ``qkv_nb`` (B, S, 3D), bias added in-kernel, with
no head-split copies around the call. When a gradient is needed it also
writes the row max m and row sum l, fp32 (B, H, S).

K2 replaces ``_fa_packed_bwd_kernel`` (:824), launched by ``_packed_bwd_impl``
(:1072): from qkv_nb, the bias, the upstream gradient and (m, l) it writes
dqkv (B, S, 3D) in the packed layout and the bias gradient, the column sums
of the fp32 dq/dk/dv.

K6 replaces ``_fa_kernel`` (:76), launched by ``_flash_attention_fwd_impl``
(:172) behind ``flash_attention`` (:1294): the same attention over q, k, v
of (B, H, S, d), taken at their strides (the head views of a packed
projection need no copies), written into a (B, S, H, d) buffer seen as
(B, H, S, d), and with (m, l) when a gradient is needed. It serves every
shape the packed path does not take (S > 768) and the KV-cache prefill.

K7/K8 is one kernel pair replacing both unpacked backwards, ``_fa_bwd_kernel``
(:201, S ≤ 768) and ``_fa_bwd_tiled_kernel`` (:284, S > 768): dq, dk, dv
from q, k, v, the upstream gradient and K6's (m, l).

What bounds them on the H100: the products, 4·S²·d FLOP per (batch, head)
forward and 10·S²·d backward (halved by a causal mask) against ≈ 8·S·d
bytes, ≈ S/2 FLOP per byte (160 at S = 320, 512 at S = 1024; the bf16 ridge
is ≈ 295). All keep every product on the tensor cores and the score,
probability and ds tiles in registers; see the sources' headers for their
blocking.

``flash_attention_packed`` and ``flash_attention`` are the entries: with a
gradient to track they run :class:`PackedAttention` (K1 with stats, then K2)
or :class:`UnpackedAttention` (K6 with stats, then K7/K8), otherwise the
forward kernel alone. Each kernel wrapper launches its kernel for a CUDA
tensor and runs its plain PyTorch version (``*_ref``) for a CPU tensor.

Dropout on the attention probabilities is the JAX kernels' counter hash
(``_dropout_mask``, :48-73), so the backward regenerates the forward's mask
exactly and the plain versions draw the same mask as the kernels and the
Pallas kernels. :func:`dropout_mask` is the hash in plain torch; the kernels
share it as ``csrc/dropout.cuh``. Per (batch, head) stream hid = b·H + h +
offset, with x = (row)·S + col over global logical coordinates and the seed
vector [seed, offset] read on the device (the offset is the JAX package's
shard offset, 0 on one device). The forward sums l before the mask, then
multiplies p = exp(s − m) by D (0 or 1/(1 − rate), fp32) before the bf16
cast; the backward takes bf16(D∘ph) into dv and multiplies dp by D before
Δ. One difference from the JAX package: it sends dropout at S > 768 to
XLA's ``bernoulli`` when ``VIT_TPU_TILED_BWD=0`` or beyond its VMEM plane
budget (:1304-1312); the port sends every S to its kernels.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from vit_tpu_torch.kernels import _build

HEAD_DIM = 64
MAX_SEQ = 768  # the JAX package's packed path bounds S here (_MAX_FUSED_BWD_SEQ)

launches = 0      # K1 launches by attention_packed_fwd, for run evidence
bwd_launches = 0  # K2 launches by attention_packed_bwd
unpacked_launches = 0      # K6 launches by attention_fwd
unpacked_bwd_launches = 0  # K7/K8 launches by attention_bwd
# Of those, the launches with dropout (a seed vector), per wrapper
dropout_launches = dropout_bwd_launches = 0
unpacked_dropout_launches = unpacked_dropout_bwd_launches = 0


def packed_supported(n_heads: int, n_embd: int, seq_len: int) -> bool:
    """Shapes the CUDA kernels take: head_dim 64 (every preset) and S ≤ 768."""
    return (n_embd % n_heads == 0 and n_embd // n_heads == HEAD_DIM
            and seq_len <= MAX_SEQ)


def split_heads(qkv: torch.Tensor, n_heads: int,
                qkv_bias: "torch.Tensor | None" = None
                ) -> "tuple[torch.Tensor, ...]":
    """The packed projection (B, S, 3D), columns ``(three h d)``, with
    ``qkv_bias`` (3D,) added in its dtype → q, k, v, each a (B, H, S, d)
    view."""
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.to(qkv.dtype)
    b, s, three_d = qkv.shape
    return qkv.reshape(b, s, 3, n_heads, three_d // 3 // n_heads).permute(
        2, 0, 3, 1, 4)


def merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B, H, S, d) → (B, S, H·d); free for K6's output, whose buffer is
    laid out (B, S, H, d)."""
    b, h, s, d = out.shape
    return out.transpose(1, 2).reshape(b, s, h * d)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x · c mod 2³² for int64 x in [0, 2³²) and a 32-bit constant c, in two
    16-bit halves of c so that no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def dropout_consts(rate: float) -> "tuple[int, float]":
    """(threshold, scale) of the keep test as the JAX package forms them on
    the host: keep where the hash ≥ uint32(int(rate · 0xFFFFFFFF)), in
    float64, and scale by float32(1 / (1 − rate))."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must lie in [0, 1), got {rate}")
    return int(rate * 0xFFFFFFFF), float(np.float32(1.0 / (1.0 - rate)))


def seed_vec(seed: torch.Tensor) -> torch.Tensor:
    """The (2,) int32 [seed, stream offset] vector the kernels read, from a
    one-element int32 seed (``_seed_vec``, :140-146), on the seed's device.
    The offset is the JAX package's shard offset: 0 on one device."""
    seed = seed.reshape(-1)
    if seed.numel() != 1:
        raise ValueError(f"seed must hold one int32, got {tuple(seed.shape)}")
    return torch.cat([seed.to(torch.int32),
                      seed.new_zeros(1, dtype=torch.int32)])


def dropout_mask(seed: torch.Tensor, hid, rows: int, cols: int, row0: int,
                 stride: int, rate: float) -> torch.Tensor:
    """The JAX kernels' keep mask (``_dropout_mask``, :48-73) in plain torch:
    fp32 (..., rows, cols), 1/(1 − rate) where kept and 0 elsewhere, for the
    stream ids ``hid`` (an int or an integer tensor, leading dims) and the
    seed vector ``seed`` (2,) int32. uint32 arithmetic runs in int64 masked
    to 32 bits."""
    dev = seed.device
    hid = torch.as_tensor(hid, dtype=torch.int64, device=dev)
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None] + row0
    c = torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
    x = (_mul32(r & _M32, stride) + c) & _M32
    x = x ^ _mul32(seed[0].long() & _M32, 0x9E3779B9)
    x = (x + _mul32(hid[..., None, None] & _M32, 0x85EBCA6B)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    threshold, scale = dropout_consts(rate)
    return torch.where(x >= threshold, scale, 0.0).to(torch.float32)


def _head_mask(seed: torch.Tensor, b: int, h: int, s: int,
               rate: float) -> torch.Tensor:
    """The mask of every (batch, head) stream over the (S, S) plane:
    (B, H, S, S) fp32, stream hid = b·H + h + seed[1]."""
    hid = (torch.arange(b * h, dtype=torch.int64, device=seed.device)
           .reshape(b, h) + seed[1].long())
    return dropout_mask(seed, hid, s, s, 0, s, rate)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 scores of the kernels: a power-of-two 1/√d is folded into q in
    the compute dtype, any other scale multiplies the fp32 product; the
    causal mask fills with the fp32 minimum."""
    scale = q.shape[-1] ** -0.5
    if scale == 2.0 ** round(math.log2(scale)):
        s = (q * scale).float() @ k.float().transpose(-1, -2)
    else:
        s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        n = q.shape[-2]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, torch.finfo(torch.float32).min)
    return s


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, emit_stats: bool = False,
                      dropout_rate: float = 0.0,
                      seed: "torch.Tensor | None" = None):
    """Plain version of K6 (and of K1 after the head split), with the
    kernels' rounding points: scores and softmax are fp32, p is cast to the
    compute dtype unnormalised and the row sum divides after the PV product.
    With dropout, l is summed before p is multiplied by the mask of the
    seed vector ``seed`` (2,). q, k, v (B, H, S, d) → out (B, H, S, d), and
    with ``emit_stats`` also m, l (B, H, S) fp32 (the unmasked sums)."""
    scores = _scores(q, k, causal)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    if dropout_rate > 0.0:
        b, h, s, _ = q.shape
        p = p * _head_mask(seed, b, h, s, dropout_rate)
    out = ((p.to(v.dtype).float() @ v.float()) / l).to(q.dtype)
    if emit_stats:
        return out, m.squeeze(-1), l.squeeze(-1)
    return out


def attention_packed_fwd_ref(qkv: torch.Tensor, bias: torch.Tensor,
                             n_heads: int, causal: bool,
                             emit_stats: bool = False,
                             dropout_rate: float = 0.0,
                             seed: "torch.Tensor | None" = None):
    """Plain version of K1: the bias is added in the compute dtype, then
    ``attention_fwd_ref`` over the heads. qkv (B, S, 3D), bias (3D,) → out
    (B, S, D), and with ``emit_stats`` also m, l (B, H, S) fp32."""
    q, k, v = split_heads(qkv, n_heads, bias)
    res = attention_fwd_ref(q, k, v, causal, emit_stats, dropout_rate, seed)
    out = merge_heads(res[0] if emit_stats else res)
    return (out, *res[1:]) if emit_stats else out


def _attention_bwd_f32(q, k, v, do, m, l, causal, dropout_rate=0.0,
                       seed=None):
    """The backward's math (``_fa_bwd_kernel``, :228-274, and K2's, :888-952):
    ph = exp(s − m) unnormalised, dv = bf16(D∘ph)ᵀ·bf16(dO/l), dp = D∘(dO·vᵀ),
    Δ = Σ ph·dp, ds = bf16(ph·(dp − Δ/l)·(scale/l)), dq = ds·k, dk = dsᵀ·q,
    with D the dropout mask (all ones without dropout). (B, H, S, d)
    operands and (B, H, S) statistics → fp32 dq, dk, dv."""
    dt = q.dtype
    b, h, s, d = q.shape
    ph = torch.exp(_scores(q, k, causal) - m[..., None])
    linv = 1.0 / l[..., None]
    dp = do.float() @ v.float().transpose(-1, -2)
    ph_eff = ph
    if dropout_rate > 0.0:
        mask = _head_mask(seed, b, h, s, dropout_rate)
        ph_eff = ph * mask
        dp = dp * mask
    dv = (ph_eff.to(dt).float().transpose(-1, -2)
          @ (do.float() * linv).to(dt).float())
    delta = (ph * dp).sum(-1, keepdim=True)
    ds = (ph * ((dp - delta * linv) * (d ** -0.5 * linv))).to(dt).float()
    return ds @ k.float(), ds.transpose(-1, -2) @ q.float(), dv


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                      causal: bool, dropout_rate: float = 0.0,
                      seed: "torch.Tensor | None" = None):
    """Plain version of K7/K8: (dq, dk, dv), (B, H, S, d) in q's dtype, from
    K6's statistics m, l (B, H, S)."""
    return tuple(g.to(q.dtype)
                 for g in _attention_bwd_f32(q, k, v, dout, m, l, causal,
                                             dropout_rate, seed))


def attention_packed_bwd_ref(qkv: torch.Tensor, bias: torch.Tensor,
                             dout: torch.Tensor, m: torch.Tensor,
                             l: torch.Tensor, n_heads: int, causal: bool,
                             dropout_rate: float = 0.0,
                             seed: "torch.Tensor | None" = None):
    """Plain version of K2: the backward's math over the biased heads.
    Returns dqkv (B, S, 3D) in qkv's dtype and the bias gradient (3D,) fp32,
    the column sums of the fp32 dq, dk and dv."""
    b, s, three_d = qkv.shape
    q, k, v = split_heads(qkv, n_heads, bias)
    do = dout.reshape(b, s, n_heads, q.shape[-1]).transpose(1, 2)
    grads = torch.stack(_attention_bwd_f32(q, k, v, do, m, l, causal,
                                           dropout_rate, seed))
    dbias = grads.sum((1, 3)).reshape(three_d)   # columns (three h d)
    dqkv = grads.permute(1, 3, 0, 2, 4).reshape(b, s, three_d).to(qkv.dtype)
    return dqkv, dbias


def _check_cuda(qkv: torch.Tensor, n_heads: int, kernel: str) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    b, s, three_d = qkv.shape
    if not packed_supported(n_heads, three_d // 3, s):
        raise NotImplementedError(
            f"{kernel} takes head_dim {HEAD_DIM} and S <= {MAX_SEQ}; got "
            f"{n_heads} heads of width {three_d // 3}, S {s}; other shapes "
            "take the unpacked kernels K6-K8 (flash_attention)")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{kernel} takes bf16 qkv, got {qkv.dtype}")


def _bias(qkv: torch.Tensor, qkv_bias: "torch.Tensor | None") -> torch.Tensor:
    three_d = qkv.shape[-1]
    bias = (qkv_bias if qkv_bias is not None
            else torch.zeros(three_d, dtype=qkv.dtype, device=qkv.device))
    if bias.shape != (three_d,):
        raise ValueError(f"qkv_bias must be ({three_d},), got "
                         f"{tuple(bias.shape)}")
    return bias


def _dropout_args(dropout_rate: float, seed: "torch.Tensor | None",
                  like: torch.Tensor):
    """(seed vector or None, threshold, scale) for a kernel launch: a (2,)
    int32 [seed, offset] vector on ``like``'s device when dropout is on."""
    threshold, scale = dropout_consts(dropout_rate)
    if dropout_rate == 0.0:
        return None, threshold, scale
    if seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    if seed.shape != (2,):
        raise ValueError(f"the kernels take a (2,) [seed, offset] vector, "
                         f"got {tuple(seed.shape)}")
    return _build.cuda_arg(seed, like, "seed", torch.int32), threshold, scale


def _ptr(t: "torch.Tensor | None"):
    return None if t is None else t.data_ptr()


def attention_packed_fwd(qkv: torch.Tensor, bias: torch.Tensor, n_heads: int,
                         causal: bool, emit_stats: bool = False,
                         dropout_rate: float = 0.0,
                         seed: "torch.Tensor | None" = None):
    """K1: (B, S, 3D), bias (3D,) → out (B, S, D) [, m, l (B, H, S) fp32];
    with ``dropout_rate`` > 0 the probabilities are dropped with the mask of
    the (2,) seed vector ``seed``. A CUDA tensor launches the kernel (bf16,
    head_dim 64, S ≤ 768) or raises; a CPU tensor runs the plain version."""
    if qkv.device.type == "cpu":
        return attention_packed_fwd_ref(qkv, bias, n_heads, causal, emit_stats,
                                        dropout_rate, seed)
    _check_cuda(qkv, n_heads, "K1")
    b, s, three_d = qkv.shape
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("K1 takes a contiguous, 16-byte aligned qkv")
    bias = _build.cuda_arg(bias, qkv, "qkv_bias", torch.bfloat16)
    seed, threshold, scale = _dropout_args(dropout_rate, seed, qkv)
    out = torch.empty(b, s, three_d // 3, dtype=torch.bfloat16,
                      device=qkv.device)
    m = l = None
    if emit_stats:
        m = torch.empty(b, n_heads, s, dtype=torch.float32, device=qkv.device)
        l = torch.empty_like(m)
    lib = _build.load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.attention_packed_fwd(
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), _ptr(m), _ptr(l),
            _ptr(seed), b, s, n_heads, int(causal), threshold, scale, stream)
    _build.check(lib, err, "attention_packed_fwd")
    global launches, dropout_launches
    launches += 1
    dropout_launches += seed is not None
    return (out, m, l) if emit_stats else out


def attention_packed_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                         dout: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         n_heads: int, causal: bool, dropout_rate: float = 0.0,
                         seed: "torch.Tensor | None" = None):
    """K2: → dqkv (B, S, 3D) in qkv's dtype, dbias (3D,) fp32; with dropout,
    the forward's mask regenerated from the same seed vector. A CUDA tensor
    launches the kernel or raises; a CPU tensor runs the plain version."""
    if qkv.device.type == "cpu":
        return attention_packed_bwd_ref(qkv, bias, dout, m, l, n_heads, causal,
                                        dropout_rate, seed)
    _check_cuda(qkv, n_heads, "K2")
    b, s, three_d = qkv.shape
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("K2 takes a contiguous, 16-byte aligned qkv")
    if dout.shape != (b, s, three_d // 3) or m.shape != (b, n_heads, s) \
            or l.shape != m.shape:
        raise ValueError(f"dout {tuple(dout.shape)}, m {tuple(m.shape)}, "
                         f"l {tuple(l.shape)} do not fit qkv {tuple(qkv.shape)}")
    bias = _build.cuda_arg(bias, qkv, "qkv_bias", torch.bfloat16)
    dout = _build.cuda_arg(dout, qkv, "dout", torch.bfloat16)
    m = _build.cuda_arg(m, qkv, "m", torch.float32)
    l = _build.cuda_arg(l, qkv, "l", torch.float32)
    seed, threshold, scale = _dropout_args(dropout_rate, seed, qkv)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty(three_d, dtype=torch.float32, device=qkv.device)
    delta = torch.empty_like(m)
    part = torch.empty(b * -(-s // HEAD_DIM), three_d, dtype=torch.float32,
                       device=qkv.device)
    lib = _build.load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.attention_packed_bwd(
            qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), m.data_ptr(),
            l.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(), delta.data_ptr(),
            part.data_ptr(), _ptr(seed), b, s, n_heads, int(causal),
            threshold, scale, stream)
    _build.check(lib, err, "attention_packed_bwd")
    global bwd_launches, dropout_bwd_launches
    bwd_launches += 1
    dropout_bwd_launches += seed is not None
    return dqkv, dbias


class PackedAttention(torch.autograd.Function):
    """(qkv_nb, bias) → out; the backward returns (dqkv, dbias). The forward
    saves K1's (m, l) and the seed vector so K2 rebuilds p and the dropout
    mask without the row reductions. Both kernels are looked up in this
    module when called, so a caller can route them elsewhere
    (``chip_smoke.py``'s plain-version run does)."""

    @staticmethod
    def forward(ctx, qkv, bias, n_heads, causal, dropout_rate, seed):
        out, m, l = attention_packed_fwd(qkv, bias, n_heads, causal,
                                         emit_stats=True,
                                         dropout_rate=dropout_rate, seed=seed)
        ctx.save_for_backward(qkv, bias, m, l, seed)
        ctx.n_heads, ctx.causal = n_heads, causal
        ctx.dropout_rate = dropout_rate
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, m, l, seed = ctx.saved_tensors
        dqkv, dbias = attention_packed_bwd(qkv, bias, dout, m, l, ctx.n_heads,
                                           ctx.causal, ctx.dropout_rate, seed)
        return dqkv, dbias.to(bias.dtype), None, None, None, None


def _entry_seed(dropout_rate: float, seed: "torch.Tensor | None",
                device) -> "torch.Tensor | None":
    """The entries' seed: a one-element int32 tensor (the JAX package draws
    it with ``jax.random.randint(rng, (1,), 0, 2**31 - 1)``) → the (2,)
    seed vector with offset 0; None without dropout."""
    dropout_consts(dropout_rate)
    if dropout_rate == 0.0:
        return None
    if seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    return seed_vec(seed.to(device))


def flash_attention_packed(qkv: torch.Tensor, n_heads: int, *,
                           causal: bool = False, dropout_rate: float = 0.0,
                           seed: "torch.Tensor | None" = None,
                           qkv_bias: "torch.Tensor | None" = None
                           ) -> torch.Tensor:
    """Attention over a packed, unbiased QKV projection: (B, S, 3D) → (B, S, D).

    ``qkv_bias`` (3D,) is added inside the kernels (zeros when None);
    gradients flow to both qkv and qkv_bias through K2. Without a gradient to
    track (inference, ``no_grad``) K1 runs alone, without its statistics.
    ``dropout_rate`` > 0 drops attention probabilities with the counter hash
    of the one-element int32 ``seed``."""
    if qkv.ndim != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, S, 3D), got {tuple(qkv.shape)}")
    bias = _bias(qkv, qkv_bias)
    seed = _entry_seed(dropout_rate, seed, qkv.device)
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return PackedAttention.apply(qkv, bias, n_heads, causal, dropout_rate,
                                     seed)
    return attention_packed_fwd(qkv, bias, n_heads, causal,
                                dropout_rate=dropout_rate, seed=seed)


def _check_unpacked(ts: "tuple[torch.Tensor, ...]", kernel: str) -> None:
    """Raise unless q, k, v (and dO) are CUDA bf16 (B, H, S, 64) alike."""
    shape = ts[0].shape
    if len(shape) != 4 or any(t.shape != shape for t in ts):
        raise ValueError(f"{kernel} takes (B, H, S, d) operands of one shape, "
                         f"got {[tuple(t.shape) for t in ts]}")
    if shape[-1] != HEAD_DIM:
        raise NotImplementedError(f"{kernel} takes head_dim {HEAD_DIM}, got "
                                  f"{shape[-1]}")
    for t in ts:
        if t.device.type != "cuda" or t.device != ts[0].device:
            raise ValueError(f"unsupported device {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} takes bf16 operands, got {t.dtype}")


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the unpacked kernels read it: unit stride along head_dim,
    the other strides multiples of 8 and a 16-byte aligned base (8 values
    are read at a time); anything else is copied."""
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) \
            or t.data_ptr() % 16:
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
    return t


def _strides(*ts: torch.Tensor):
    """(batch, head, row) element strides of each operand, as a C array."""
    flat = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, emit_stats: bool = False,
                  dropout_rate: float = 0.0,
                  seed: "torch.Tensor | None" = None):
    """K6: q, k, v (B, H, S, 64) → out (B, H, S, 64) [, m, l (B, H, S) fp32];
    with ``dropout_rate`` > 0 the probabilities are dropped with the mask of
    the (2,) seed vector ``seed``. On CUDA the output is a (B, H, S, 64)
    view of a contiguous (B, S, H, 64) buffer, so merging the heads back is
    free. A CUDA tensor launches the kernel (bf16, head_dim 64) or raises; a
    CPU tensor runs the plain version."""
    if q.device.type == "cpu":
        return attention_fwd_ref(q, k, v, causal, emit_stats, dropout_rate,
                                 seed)
    _check_unpacked((q, k, v), "K6")
    q, k, v = (_strided(t) for t in (q, k, v))
    b, h, s, d = q.shape
    seed, threshold, scale = _dropout_args(dropout_rate, seed, q)
    out = torch.empty(b, s, h, d, dtype=torch.bfloat16,
                      device=q.device).transpose(1, 2)
    m = l = None
    if emit_stats:
        m = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(m),
            _ptr(l), _ptr(seed), _strides(q, k, v, out), b, s, h, int(causal),
            threshold, scale, stream)
    _build.check(lib, err, "attention_fwd")
    global unpacked_launches, unpacked_dropout_launches
    unpacked_launches += 1
    unpacked_dropout_launches += seed is not None
    return (out, m, l) if emit_stats else out


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                  causal: bool, dropout_rate: float = 0.0,
                  seed: "torch.Tensor | None" = None):
    """K7/K8: → (dq, dk, dv), (B, H, S, 64) in q's dtype, from K6's m, l;
    with dropout, the forward's mask regenerated from the same seed vector.
    A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
    version."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, dout, m, l, causal, dropout_rate,
                                 seed)
    _check_unpacked((q, k, v, dout), "K7/K8")
    b, h, s, d = q.shape
    if m.shape != (b, h, s) or l.shape != m.shape:
        raise ValueError(f"m {tuple(m.shape)}, l {tuple(l.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    q, k, v, dout = (_strided(t) for t in (q, k, v, dout))
    m = _build.cuda_arg(m, q, "m", torch.float32)
    l = _build.cuda_arg(l, q, "l", torch.float32)
    seed, threshold, scale = _dropout_args(dropout_rate, seed, q)
    dq, dk, dv = (torch.empty(b, h, s, d, dtype=torch.bfloat16,
                              device=q.device) for _ in range(3))
    delta = torch.empty_like(m)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            m.data_ptr(), l.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), _ptr(seed),
            _strides(q, k, v, dout, dq, dk, dv), b, s, h, int(causal),
            threshold, scale, stream)
    _build.check(lib, err, "attention_bwd")
    global unpacked_bwd_launches, unpacked_dropout_bwd_launches
    unpacked_bwd_launches += 1
    unpacked_dropout_bwd_launches += seed is not None
    return dq, dk, dv


class UnpackedAttention(torch.autograd.Function):
    """(q, k, v) → out; the backward returns (dq, dk, dv). The forward saves
    K6's (m, l) and the seed vector so K7/K8 rebuilds p and the dropout mask
    without the row reductions. The kernels are looked up in this module
    when called, as ``PackedAttention``'s."""

    @staticmethod
    def forward(ctx, q, k, v, causal, dropout_rate, seed):
        out, m, l = attention_fwd(q, k, v, causal, emit_stats=True,
                                  dropout_rate=dropout_rate, seed=seed)
        ctx.save_for_backward(q, k, v, m, l, seed)
        ctx.causal, ctx.dropout_rate = causal, dropout_rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, m, l, seed = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, dout, m, l, ctx.causal,
                                   ctx.dropout_rate, seed)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, dropout_rate: float = 0.0,
                    seed: "torch.Tensor | None" = None) -> torch.Tensor:
    """Attention over q, k, v (B, H, S, d) → (B, H, S, d), any S. With a
    gradient to track, K6 saves its statistics and K7/K8 runs in the
    backward; otherwise K6 runs alone. ``dropout_rate`` > 0 drops attention
    probabilities with the counter hash of the one-element int32 ``seed``."""
    seed = _entry_seed(dropout_rate, seed, q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return UnpackedAttention.apply(q, k, v, causal, dropout_rate, seed)
    return attention_fwd(q, k, v, causal, dropout_rate=dropout_rate,
                         seed=seed)
