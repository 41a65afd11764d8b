"""K1 and K2: packed-QKV attention forward and backward (CUDA C++,
``csrc/attention_packed_fwd.cu`` and ``csrc/attention_packed_bwd.cu``).

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

What bounds them on the H100: the products, 4·S²·d FLOP per (batch, head)
forward and 10·S²·d backward against ≈ 8·S·d bytes, ≈ S/2 FLOP per byte (160
at S = 320, near the bf16 ridge). Both keep every product on the tensor
cores and the score, probability and ds tiles in registers; see the sources'
headers for their blocking.

``flash_attention_packed`` is the entry: with a gradient to track it runs
:class:`PackedAttention` (K1 with stats, then K2 in the backward), otherwise K1
alone. Each kernel wrapper launches its kernel for a CUDA tensor and runs its
plain PyTorch version (``*_ref``) for a CPU tensor. In-kernel dropout (the
murmur3 hash ``_dropout_mask``, :48-73) is not ported.
"""

from __future__ import annotations

import math

import torch

from vit_tpu_torch.kernels import _build

HEAD_DIM = 64
MAX_SEQ = 768  # the JAX package's packed path bounds S here (_MAX_FUSED_BWD_SEQ)

launches = 0      # K1 launches by attention_packed_fwd, for run evidence
bwd_launches = 0  # K2 launches by attention_packed_bwd


def packed_supported(n_heads: int, n_embd: int, seq_len: int) -> bool:
    """Shapes the CUDA kernels take: head_dim 64 (every preset) and S ≤ 768."""
    return (n_embd % n_heads == 0 and n_embd // n_heads == HEAD_DIM
            and seq_len <= MAX_SEQ)


def _heads(x: torch.Tensor, n_heads: int) -> "tuple[torch.Tensor, ...]":
    """(B, S, 3D) → q, k, v, each (B, H, S, d)."""
    b, s, three_d = x.shape
    return x.reshape(b, s, 3, n_heads, three_d // 3 // n_heads).permute(
        2, 0, 3, 1, 4)


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


def attention_packed_fwd_ref(qkv: torch.Tensor, bias: torch.Tensor,
                             n_heads: int, causal: bool,
                             emit_stats: bool = False):
    """Plain version of K1, with its rounding points: the bias is added in
    the compute dtype, scores and softmax are fp32, p is cast unnormalised
    and the sum divides after the PV product. qkv (B, S, 3D), bias (3D,) →
    out (B, S, D), and with ``emit_stats`` also m, l (B, H, S) fp32."""
    b, s, three_d = qkv.shape
    q, k, v = _heads(qkv + bias.to(qkv.dtype), n_heads)
    scores = _scores(q, k, causal)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    out = (p.to(qkv.dtype).float() @ v.float()) / l
    out = out.to(qkv.dtype).transpose(1, 2).reshape(b, s, three_d // 3)
    if emit_stats:
        return out, m.squeeze(-1), l.squeeze(-1)
    return out


def attention_packed_bwd_ref(qkv: torch.Tensor, bias: torch.Tensor,
                             dout: torch.Tensor, m: torch.Tensor,
                             l: torch.Tensor, n_heads: int, causal: bool):
    """Plain version of K2 (the math of ``_fa_packed_bwd_kernel``, :888-952):
    ph = exp(s − m) unnormalised, dv = bf16(ph)ᵀ·bf16(dO/l), dp = dO·vᵀ,
    Δ = Σ ph·dp, ds = bf16(ph·(dp − Δ/l)·(scale/l)), dq = ds·k, dk = dsᵀ·q.
    Returns dqkv (B, S, 3D) in qkv's dtype and the bias gradient (3D,) fp32,
    the column sums of the fp32 dq, dk and dv."""
    dt = qkv.dtype
    b, s, three_d = qkv.shape
    q, k, v = _heads(qkv + bias.to(dt), n_heads)
    d = q.shape[-1]
    do = dout.reshape(b, s, n_heads, d).transpose(1, 2)
    ph = torch.exp(_scores(q, k, causal) - m[..., None])
    linv = 1.0 / l[..., None]
    dv = ph.to(dt).float().transpose(-1, -2) @ (do.float() * linv).to(dt).float()
    dp = do.float() @ v.float().transpose(-1, -2)
    delta = (ph * dp).sum(-1, keepdim=True)
    ds = (ph * ((dp - delta * linv) * (d ** -0.5 * linv))).to(dt).float()
    dq = ds @ k.float()
    dk = ds.transpose(-1, -2) @ q.float()
    grads = torch.stack([dq, dk, dv])            # (3, B, H, S, d) fp32
    dbias = grads.sum((1, 3)).reshape(three_d)   # columns (three h d)
    dqkv = grads.permute(1, 3, 0, 2, 4).reshape(b, s, three_d).to(dt)
    return dqkv, dbias


def _check_cuda(qkv: torch.Tensor, n_heads: int, kernel: str) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    b, s, three_d = qkv.shape
    if not packed_supported(n_heads, three_d // 3, s):
        raise NotImplementedError(
            f"{kernel} takes head_dim {HEAD_DIM} and S <= {MAX_SEQ}; got "
            f"{n_heads} heads of width {three_d // 3}, S {s}. The unpacked "
            "attention kernels K6-K8 (vit_tpu/kernels/attention.py:_fa_kernel, "
            "_fa_bwd_kernel) are not ported yet")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{kernel} takes bf16 qkv, got {qkv.dtype}")


def _cuda_arg(t: torch.Tensor, like: torch.Tensor, name: str,
              dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous, 16-byte aligned ``dtype`` tensor on ``like``'s
    device (the kernels read 8 values at a time)."""
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, qkv on {like.device}")
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bias(qkv: torch.Tensor, qkv_bias: "torch.Tensor | None") -> torch.Tensor:
    three_d = qkv.shape[-1]
    bias = (qkv_bias if qkv_bias is not None
            else torch.zeros(three_d, dtype=qkv.dtype, device=qkv.device))
    if bias.shape != (three_d,):
        raise ValueError(f"qkv_bias must be ({three_d},), got "
                         f"{tuple(bias.shape)}")
    return bias


def attention_packed_fwd(qkv: torch.Tensor, bias: torch.Tensor, n_heads: int,
                         causal: bool, emit_stats: bool = False):
    """K1: (B, S, 3D), bias (3D,) → out (B, S, D) [, m, l (B, H, S) fp32].
    A CUDA tensor launches the kernel (bf16, head_dim 64, S ≤ 768) or raises;
    a CPU tensor runs the plain version."""
    if qkv.device.type == "cpu":
        return attention_packed_fwd_ref(qkv, bias, n_heads, causal, emit_stats)
    _check_cuda(qkv, n_heads, "K1")
    b, s, three_d = qkv.shape
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("K1 takes a contiguous, 16-byte aligned qkv")
    bias = _cuda_arg(bias, qkv, "qkv_bias", torch.bfloat16)
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
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if m is None else m.data_ptr(),
            None if l is None else l.data_ptr(), b, s, n_heads, int(causal),
            stream)
    _build.check(lib, err, "attention_packed_fwd")
    global launches
    launches += 1
    return (out, m, l) if emit_stats else out


def attention_packed_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                         dout: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         n_heads: int, causal: bool):
    """K2: → dqkv (B, S, 3D) in qkv's dtype, dbias (3D,) fp32. A CUDA tensor
    launches the kernel or raises; a CPU tensor runs the plain version."""
    if qkv.device.type == "cpu":
        return attention_packed_bwd_ref(qkv, bias, dout, m, l, n_heads, causal)
    _check_cuda(qkv, n_heads, "K2")
    b, s, three_d = qkv.shape
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("K2 takes a contiguous, 16-byte aligned qkv")
    if dout.shape != (b, s, three_d // 3) or m.shape != (b, n_heads, s) \
            or l.shape != m.shape:
        raise ValueError(f"dout {tuple(dout.shape)}, m {tuple(m.shape)}, "
                         f"l {tuple(l.shape)} do not fit qkv {tuple(qkv.shape)}")
    bias = _cuda_arg(bias, qkv, "qkv_bias", torch.bfloat16)
    dout = _cuda_arg(dout, qkv, "dout", torch.bfloat16)
    m = _cuda_arg(m, qkv, "m", torch.float32)
    l = _cuda_arg(l, qkv, "l", torch.float32)
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
            part.data_ptr(), b, s, n_heads, int(causal), stream)
    _build.check(lib, err, "attention_packed_bwd")
    global bwd_launches
    bwd_launches += 1
    return dqkv, dbias


class PackedAttention(torch.autograd.Function):
    """(qkv_nb, bias) → out; the backward returns (dqkv, dbias). The forward
    saves K1's (m, l) so K2 rebuilds p without the row reductions. Both
    kernels are looked up in this module when called, so a caller can route
    them elsewhere (``chip_smoke.py``'s plain-version run does)."""

    @staticmethod
    def forward(ctx, qkv, bias, n_heads, causal):
        out, m, l = attention_packed_fwd(qkv, bias, n_heads, causal,
                                         emit_stats=True)
        ctx.save_for_backward(qkv, bias, m, l)
        ctx.n_heads, ctx.causal = n_heads, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, m, l = ctx.saved_tensors
        dqkv, dbias = attention_packed_bwd(qkv, bias, dout, m, l, ctx.n_heads,
                                           ctx.causal)
        return dqkv, dbias.to(bias.dtype), None, None


def flash_attention_packed(qkv: torch.Tensor, n_heads: int, *,
                           causal: bool = False, dropout_rate: float = 0.0,
                           qkv_bias: "torch.Tensor | None" = None
                           ) -> torch.Tensor:
    """Attention over a packed, unbiased QKV projection: (B, S, 3D) → (B, S, D).

    ``qkv_bias`` (3D,) is added inside the kernels (zeros when None);
    gradients flow to both qkv and qkv_bias through K2. Without a gradient to
    track (inference, ``no_grad``) K1 runs alone, without its statistics."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout (the counter hash of vit_tpu/kernels/"
            "attention.py:_dropout_mask, :48-73) is not ported yet")
    if qkv.ndim != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, S, 3D), got {tuple(qkv.shape)}")
    bias = _bias(qkv, qkv_bias)
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return PackedAttention.apply(qkv, bias, n_heads, causal)
    return attention_packed_fwd(qkv, bias, n_heads, causal)
