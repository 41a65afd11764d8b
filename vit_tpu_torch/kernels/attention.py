"""Attention kernels: K6 with K7/K8, unpacked attention forward and backward
(CUDA C++, ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``), and K1
and K2, packed-QKV attention forward and backward: the same kernels
instantiated with their bias stage (``kBias``), behind the entries
``attention_packed_fwd`` and ``attention_packed_bwd`` of the same sources.

K1 replaces the Pallas kernel ``vit_tpu/kernels/attention.py:_fa_packed_kernel``
(:623), launched by ``_packed_fwd_impl`` (:790) behind
``flash_attention_packed`` (:1269): softmax(q kᵀ/√d)·v straight off the
unbiased packed projection ``qkv_nb`` (B, S, 3D), bias added in-kernel, with
no head-split copies around the call: q, k and v are read as qkv_nb's head
views through TMA, and each tile gets the bias in bf16 in shared memory
before a product reads it. When a gradient is needed it also writes the row
max m and row sum l, fp32 (B, H, S).

K2 replaces ``_fa_packed_bwd_kernel`` (:824), launched by ``_packed_bwd_impl``
(:1072): from qkv_nb, the bias, the upstream gradient and (m, l) it writes
dqkv (B, S, 3D) in the packed layout (dq, dk, dv as its strided views) and
the bias gradient, the column sums of the fp32 dq/dk/dv: one partial row
per 128-row block, summed in order.

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

fp32 operands (``--mixed false``, where the Pallas kernels take their
products at Precision.HIGHEST) launch the fp32 forms, for both layouts,
with the same (m, l) statistics and the same dropout mask: the forward's
kernel of ``csrc/attention_fwd.cu`` and the backward's kernel pair of
``csrc/attention_bwd.cu``, each instantiated on three bf16 parts of each
fp32 operand (x = x0 + x1 + x2, written by a pre-split pass,
:func:`split_parts`), every product the six bf16 tensor-core products of
the TPU's HIGHEST, fp32 outputs. Every wrapper takes bf16 or fp32 operands
of one dtype and counts its fp32 launches apart (``fp32_*``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from vit_tpu_torch.kernels import _build

# The head widths the CUDA kernels are instantiated for: 64 (every preset)
# and 32 (the MAE decoder's 16 heads × 512). The JAX kernels take others
# (the packed path any divisor of 128, the unpacked any width); on CUDA the
# port refuses them, naming ROADMAP Queue A #11.
HEAD_DIMS = (32, 64)
LANES = 128     # the packed path's lane block (_LANES)
MAX_SEQ = 768   # the JAX package's packed path bounds S here (_MAX_FUSED_BWD_SEQ)

launches = 0      # K1 launches by attention_packed_fwd, for run evidence
bwd_launches = 0  # K2 launches by attention_packed_bwd
unpacked_launches = 0      # K6 launches by attention_fwd
unpacked_bwd_launches = 0  # K7/K8 launches by attention_bwd
# Of those, the launches with dropout (a seed vector), per wrapper
dropout_launches = dropout_bwd_launches = 0
unpacked_dropout_launches = unpacked_dropout_bwd_launches = 0
# Of those, the launches of the fp32 forms (fp32 operands), per wrapper
fp32_launches = fp32_bwd_launches = 0
unpacked_fp32_launches = unpacked_fp32_bwd_launches = 0
# Every launch again by head width: wrapper → {head_dim: launches}
head_dim_launches = {name: dict.fromkeys(HEAD_DIMS, 0) for name in (
    "attention_packed_fwd", "attention_packed_bwd", "attention_fwd",
    "attention_bwd")}


def reset_head_dim_launches() -> None:
    for counts in head_dim_launches.values():
        counts.update(dict.fromkeys(counts, 0))


def packed_supported(n_heads: int, n_embd: int, seq_len: int) -> bool:
    """The JAX package's rule for the packed path (``packed_supported``,
    :610-620): heads of a width dividing the 128-lane block, a width a
    multiple of 128, and S ≤ 768. On CUDA the packed kernels take the
    widths in ``HEAD_DIMS`` and refuse the rest (:func:`check_head_dim`)."""
    if n_embd % n_heads:
        return False
    d = n_embd // n_heads
    return LANES % d == 0 and n_embd % LANES == 0 and seq_len <= MAX_SEQ


def check_head_dim(d: int, kernel: str) -> None:
    """Raise unless the CUDA kernels have an instantiation for head_dim d."""
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"{kernel} is built for head_dim {' and '.join(map(str, HEAD_DIMS))}"
            f" on CUDA, got {d} (the other widths the JAX kernels take: "
            "ROADMAP Queue A #11)")


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


def _check_cuda(qkv: torch.Tensor, n_heads: int, kernel: str,
                *more: torch.Tensor) -> None:
    _build.compute_dtype(kernel, qkv, *more)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    b, s, three_d = qkv.shape
    if not packed_supported(n_heads, three_d // 3, s):
        raise NotImplementedError(
            f"{kernel} takes heads of a width dividing {LANES}, a width a "
            f"multiple of {LANES} and S <= {MAX_SEQ}; got {n_heads} heads "
            f"of width {three_d // 3}, S {s}; other shapes take the "
            "unpacked kernels K6-K8 (flash_attention)")
    check_head_dim(three_d // 3 // n_heads, kernel)


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


def _bias_parts(bias: "torch.Tensor | None"):
    """The (3D,) bias as its q, k and v parts (views), or three Nones."""
    return (None,) * 3 if bias is None else bias.view(3, -1).unbind(0)


def _parts(q: torch.Tensor, ops: int) -> torch.Tensor:
    """The fp32 forms' workspace of bf16 parts: (ops, B, H, S, 3, d), part
    p of q, k, v (biased) and, in the backward's (ops 4), dO at
    [operand][b][h][s][p]."""
    b, h, s, d = q.shape
    return torch.empty(ops, b, h, s, 3, d, dtype=torch.bfloat16,
                       device=q.device)


def _split(lib, q, k, v, bias, dout, stream) -> torch.Tensor:
    """Launch the pre-split (``attention_f32_split``) of q, k, v with the
    packed layout's (3D,) bias or None, and dO or None (the forward's), on
    ``stream``; returns the parts."""
    b, h, s, d = q.shape
    parts = _parts(q, 3 if dout is None else 4)
    bq, bk, bv = _bias_parts(bias)
    ops = (q, k, v) if dout is None else (q, k, v, dout)
    err = lib.attention_f32_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bq), _ptr(bk),
        _ptr(bv), _ptr(dout), parts.data_ptr(), _strides(*ops), b, s, h, d,
        stream)
    _build.check(lib, err, "attention_f32_split")
    return parts


def _f32_fwd(q, k, v, bias, out, emit_stats: bool, seed, threshold: int,
             scale: float, causal: bool):
    """Launch the fp32 forward (the pre-split of q, k and v, then
    ``attention_f32_fwd``, the split-product kernel) over the (B, H, S, d)
    views q, k, v and out, with the packed layout's (3D,) bias or None;
    returns (m, l), or (None, None) without ``emit_stats``."""
    b, h, s, d = q.shape
    m = l = None
    if emit_stats:
        m = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        parts = _split(lib, q, k, v, bias, None, stream)
        err = lib.attention_f32_fwd(
            parts.data_ptr(), out.data_ptr(), _ptr(m), _ptr(l), _ptr(seed),
            _strides(out), b, s, h, d, int(causal), threshold, scale, stream)
    _build.check(lib, err, "attention_f32_fwd")
    return m, l


def _f32_bwd(q, k, v, bias, dout, m, l, dq, dk, dv, seed, threshold: int,
             scale: float, causal: bool) -> "torch.Tensor | None":
    """Launch the fp32 backward (``attention_f32_bwd``: the pre-split, then
    the split-product dq and dk/dv kernels) into the (B, H, S, d) views
    dq, dk, dv; with the packed layout's (3D,) bias also its fp32 gradient,
    which is returned (None without a bias)."""
    b, h, s, d = q.shape
    delta = torch.empty_like(m)
    lib = _build.load()
    part = dbias = None
    if bias is not None:
        part = torch.empty(b * -(-s // lib.attention_bwd_block_rows()),
                           bias.numel(), dtype=torch.float32, device=q.device)
        dbias = torch.empty(bias.numel(), dtype=torch.float32,
                            device=q.device)
    bq, bk, bv = _bias_parts(bias)
    parts = _parts(q, 4)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_f32_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bq), _ptr(bk),
            _ptr(bv), dout.data_ptr(), m.data_ptr(), l.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            parts.data_ptr(), _ptr(part), _ptr(dbias), _ptr(seed),
            _strides(q, k, v, dout, dq, dk, dv), b, s, h, d, int(causal),
            threshold, scale, stream)
    _build.check(lib, err, "attention_f32_bwd")
    return dbias


def split3(x: torch.Tensor) -> "tuple[torch.Tensor, ...]":
    """fp32 ``x`` as three bf16 parts with x = x0 + x1 + x2 exactly (while x2
    is a normal bf16: |x| above about 2⁻¹¹⁰): x0 = bf16(x), x1 = bf16(x −
    x0), x2 = bf16(x − x0 − x1). The fp32 forms' operands and A fragments
    are split so (``csrc/hopper.cuh:put_a``)."""
    parts, r = [], x.float()
    for _ in range(3):
        p = r.to(torch.bfloat16)
        parts.append(p)
        r = r - p.float()
    return tuple(parts)


def split_parts_ref(q, k, v, dout=None, bias: "torch.Tensor | None" = None
                    ) -> torch.Tensor:
    """Plain version of the fp32 forms' pre-split pass: q, k, v (plus the
    packed layout's (3D,) bias, q's part at h·d, k's at D + h·d, v's at
    2D + h·d) and dO, fp32 (B, H, S, d) → (4, B, H, S, 3, d) bf16; without
    dO (the forward's) → (3, B, H, S, 3, d)."""
    ops = [q, k, v]
    if bias is not None:
        ops = [x + bp.view(-1, 1, q.shape[-1])
               for x, bp in zip(ops, _bias_parts(bias))]
    if dout is not None:
        ops.append(dout)
    return torch.stack([torch.stack(split3(x), -2) for x in ops])


def split_parts(q, k, v, dout=None, bias: "torch.Tensor | None" = None
                ) -> torch.Tensor:
    """The fp32 forms' pre-split pass alone, the launch that the fp32
    backward (``attention_f32_bwd``) makes first and the fp32 forward's
    wrapper makes before its kernel (without dO), to check it against
    :func:`split_parts_ref` and time it: CUDA fp32 (B, H, S, d) operands at
    the strides the kernels take → (4, B, H, S, 3, d) bf16, or (3, ...)
    without dO."""
    ops = tuple(t for t in (q, k, v, dout) if t is not None)
    _check_unpacked(ops, "the pre-split")
    if q.dtype != torch.float32:
        raise TypeError(f"the pre-split takes fp32 operands, got {q.dtype}")
    q, k, v, *rest = (_strided(t) for t in ops)
    if bias is not None:
        bias = _build.cuda_arg(bias, q, "qkv_bias", torch.float32)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return _split(lib, q, k, v, bias, rest[0] if rest else None, stream)


def attention_packed_fwd(qkv: torch.Tensor, bias: torch.Tensor, n_heads: int,
                         causal: bool, emit_stats: bool = False,
                         dropout_rate: float = 0.0,
                         seed: "torch.Tensor | None" = None):
    """K1: (B, S, 3D), bias (3D,) → out (B, S, D) [, m, l (B, H, S) fp32];
    with ``dropout_rate`` > 0 the probabilities are dropped with the mask of
    the (2,) seed vector ``seed``. A CUDA tensor launches the kernel (bf16
    or fp32, head_dim 32 or 64, S ≤ 768) or raises; a CPU tensor runs the
    plain version."""
    if qkv.device.type == "cpu":
        return attention_packed_fwd_ref(qkv, bias, n_heads, causal, emit_stats,
                                        dropout_rate, seed)
    _check_cuda(qkv, n_heads, "K1")
    b, s, three_d = qkv.shape
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("K1 takes a contiguous, 16-byte aligned qkv")
    bias = _build.cuda_arg(bias, qkv, "qkv_bias", qkv.dtype)
    seed, threshold, scale = _dropout_args(dropout_rate, seed, qkv)
    d = three_d // 3 // n_heads
    out = torch.empty(b, s, three_d // 3, dtype=qkv.dtype, device=qkv.device)
    if qkv.dtype == torch.float32:
        m, l = _f32_fwd(*split_heads(qkv, n_heads), bias,
                        out.view(b, s, n_heads, d).transpose(1, 2),
                        emit_stats, seed, threshold, scale, causal)
    else:
        m = l = None
        if emit_stats:
            m = torch.empty(b, n_heads, s, dtype=torch.float32,
                            device=qkv.device)
            l = torch.empty_like(m)
        lib = _build.load()
        with torch.cuda.device(qkv.device):
            stream = torch.cuda.current_stream(qkv.device).cuda_stream
            err = lib.attention_packed_fwd(
                qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), _ptr(m),
                _ptr(l), _ptr(seed), b, s, n_heads, d, int(causal),
                threshold, scale, stream)
        _build.check(lib, err, "attention_packed_fwd")
    global launches, dropout_launches, fp32_launches
    launches += 1
    head_dim_launches["attention_packed_fwd"][d] += 1
    dropout_launches += seed is not None
    fp32_launches += qkv.dtype == torch.float32
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
    _check_cuda(qkv, n_heads, "K2", dout)
    b, s, three_d = qkv.shape
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("K2 takes a contiguous, 16-byte aligned qkv")
    if dout.shape != (b, s, three_d // 3) or m.shape != (b, n_heads, s) \
            or l.shape != m.shape:
        raise ValueError(f"dout {tuple(dout.shape)}, m {tuple(m.shape)}, "
                         f"l {tuple(l.shape)} do not fit qkv {tuple(qkv.shape)}")
    bias = _build.cuda_arg(bias, qkv, "qkv_bias", qkv.dtype)
    dout = _build.cuda_arg(dout, qkv, "dout", qkv.dtype)
    m = _build.cuda_arg(m, qkv, "m", torch.float32)
    l = _build.cuda_arg(l, qkv, "l", torch.float32)
    seed, threshold, scale = _dropout_args(dropout_rate, seed, qkv)
    d = three_d // 3 // n_heads
    dqkv = torch.empty_like(qkv)
    if qkv.dtype == torch.float32:
        do = dout.view(b, s, n_heads, d).transpose(1, 2)
        dbias = _f32_bwd(*split_heads(qkv, n_heads), bias, do, m, l,
                         *split_heads(dqkv, n_heads), seed, threshold, scale,
                         causal)
    else:
        lib = _build.load()
        dbias = torch.empty(three_d, dtype=torch.float32, device=qkv.device)
        delta = torch.empty_like(m)
        part = torch.empty(b * -(-s // lib.attention_bwd_block_rows()),
                           three_d, dtype=torch.float32, device=qkv.device)
        with torch.cuda.device(qkv.device):
            stream = torch.cuda.current_stream(qkv.device).cuda_stream
            err = lib.attention_packed_bwd(
                qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(),
                m.data_ptr(), l.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
                delta.data_ptr(), part.data_ptr(), _ptr(seed), b, s, n_heads,
                d, int(causal), threshold, scale, stream)
        _build.check(lib, err, "attention_packed_bwd")
    global bwd_launches, dropout_bwd_launches, fp32_bwd_launches
    bwd_launches += 1
    head_dim_launches["attention_packed_bwd"][d] += 1
    fp32_bwd_launches += qkv.dtype == torch.float32
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
        ctx.dropout_rate, ctx.dtype = dropout_rate, qkv.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, m, l, seed = ctx.saved_tensors
        dqkv, dbias = attention_packed_bwd(qkv, bias, dout.to(ctx.dtype), m, l,
                                           ctx.n_heads, ctx.causal,
                                           ctx.dropout_rate, seed)
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
    """Raise unless q, k, v (and dO) are CUDA (B, H, S, d) alike, d 32 or
    64, all bf16 or all fp32."""
    _build.compute_dtype(kernel, *ts)
    shape = ts[0].shape
    if len(shape) != 4 or any(t.shape != shape for t in ts):
        raise ValueError(f"{kernel} takes (B, H, S, d) operands of one shape, "
                         f"got {[tuple(t.shape) for t in ts]}")
    check_head_dim(shape[-1], kernel)
    for t in ts:
        if t.device.type != "cuda" or t.device != ts[0].device:
            raise ValueError(f"unsupported device {t.device}")


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the unpacked kernels read it: unit stride along head_dim,
    the other strides multiples of 8 and a 16-byte aligned base (the bf16
    kernels' TMA tensor maps take 16-byte strides and bases, the fp32 forms
    read 16 bytes at a time); anything else is copied."""
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
    """K6: q, k, v (B, H, S, d) → out (B, H, S, d) [, m, l (B, H, S) fp32];
    with ``dropout_rate`` > 0 the probabilities are dropped with the mask of
    the (2,) seed vector ``seed``. On CUDA the output is a (B, H, S, d)
    view of a contiguous (B, S, H, d) buffer, so merging the heads back is
    free. A CUDA tensor launches the kernel (bf16 or fp32, head_dim 32 or
    64) or raises; a CPU tensor runs the plain version."""
    if q.device.type == "cpu":
        return attention_fwd_ref(q, k, v, causal, emit_stats, dropout_rate,
                                 seed)
    _check_unpacked((q, k, v), "K6")
    q, k, v = (_strided(t) for t in (q, k, v))
    b, h, s, d = q.shape
    seed, threshold, scale = _dropout_args(dropout_rate, seed, q)
    out = torch.empty(b, s, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if q.dtype == torch.float32:
        m, l = _f32_fwd(q, k, v, None, out, emit_stats, seed, threshold,
                        scale, causal)
    else:
        m = l = None
        if emit_stats:
            m = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
            l = torch.empty_like(m)
        lib = _build.load()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _ptr(m), _ptr(l), _ptr(seed), _strides(q, k, v, out), b, s, h,
                d, int(causal), threshold, scale, stream)
        _build.check(lib, err, "attention_fwd")
    global unpacked_launches, unpacked_dropout_launches, unpacked_fp32_launches
    unpacked_launches += 1
    head_dim_launches["attention_fwd"][d] += 1
    unpacked_dropout_launches += seed is not None
    unpacked_fp32_launches += q.dtype == torch.float32
    return (out, m, l) if emit_stats else out


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                  causal: bool, dropout_rate: float = 0.0,
                  seed: "torch.Tensor | None" = None):
    """K7/K8: → (dq, dk, dv), (B, H, S, d) in q's dtype, from K6's m, l;
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
    dq, dk, dv = (torch.empty(b, h, s, d, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if q.dtype == torch.float32:
        _f32_bwd(q, k, v, None, dout, m, l, dq, dk, dv, seed, threshold,
                 scale, causal)
    else:
        delta = torch.empty_like(m)
        lib = _build.load()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                m.data_ptr(), l.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), delta.data_ptr(), _ptr(seed),
                _strides(q, k, v, dout, dq, dk, dv), b, s, h, d, int(causal),
                threshold, scale, stream)
        _build.check(lib, err, "attention_bwd")
    global unpacked_bwd_launches, unpacked_dropout_bwd_launches, \
        unpacked_fp32_bwd_launches
    unpacked_bwd_launches += 1
    head_dim_launches["attention_bwd"][d] += 1
    unpacked_dropout_bwd_launches += seed is not None
    unpacked_fp32_bwd_launches += q.dtype == torch.float32
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
        ctx.dtype = q.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, m, l, seed = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, dout.to(ctx.dtype), m, l,
                                   ctx.causal, ctx.dropout_rate, seed)
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
