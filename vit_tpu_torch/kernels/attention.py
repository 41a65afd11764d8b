"""K1: packed-QKV attention forward (CUDA C++, ``csrc/attention_packed_fwd.cu``).

Replaces the Pallas kernel ``vit_tpu/kernels/attention.py:_fa_packed_kernel``
(:623), launched by ``_packed_fwd_impl`` (:790) behind
``flash_attention_packed`` (:1269): softmax(q kᵀ/√d)·v straight off the
unbiased packed projection ``qkv_nb`` (B, S, 3D), bias added in-kernel, with
no head-split copies around the call.

What bounds it on the H100: the two products, 4·S²·d FLOP per (batch, head)
against ≈ 8·S·d bytes, ≈ S/2 FLOP per byte (160 at the serving S = 320, near
the bf16 ridge). The kernel keeps both products on the tensor cores and the
score and probability tiles in registers, and streams K/V in 64-row tiles
twice: once for the exact row max, once for p and P·V, so p is rounded where
the TPU kernel rounds it (see the source's header).

``flash_attention_packed`` launches the kernel for a CUDA tensor and runs
``flash_attention_packed_ref``, its plain PyTorch version, for a CPU tensor.
Forward only: in-kernel dropout (the murmur3 hash ``_dropout_mask``,
:48-73) and the (m, l) statistics for the backward are training features that
come with the backward port (K2).
"""

from __future__ import annotations

import math

import torch

from vit_tpu_torch.kernels import _build

HEAD_DIM = 64
MAX_SEQ = 768  # the JAX package's packed path bounds S here (_MAX_FUSED_BWD_SEQ)

launches = 0  # kernel launches by flash_attention_packed, for run evidence


def packed_supported(n_heads: int, n_embd: int, seq_len: int) -> bool:
    """Shapes the CUDA kernel takes: head_dim 64 (every preset) and S ≤ 768."""
    return (n_embd % n_heads == 0 and n_embd // n_heads == HEAD_DIM
            and seq_len <= MAX_SEQ)


def flash_attention_packed_ref(qkv: torch.Tensor, bias: torch.Tensor,
                               n_heads: int, causal: bool) -> torch.Tensor:
    """Plain version of the kernel, with its rounding points: the bias is
    added in the compute dtype, a power-of-two 1/√d is folded into q, scores
    and softmax are fp32, p is cast unnormalised and the sum divides after
    the PV product. qkv (B, S, 3D), bias (3D,) → (B, S, D)."""
    b, s, three_d = qkv.shape
    n_embd = three_d // 3
    d = n_embd // n_heads
    x = qkv + bias.to(qkv.dtype)
    q, k, v = x.reshape(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    scale = d ** -0.5
    scale_pow2 = scale == 2.0 ** round(math.log2(scale))
    if scale_pow2:
        q = q * scale
    scores = q.float() @ k.float().transpose(-1, -2)
    if not scale_pow2:
        scores = scores * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=qkv.device).tril()
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    out = (p.to(qkv.dtype).float() @ v.float()) / p.sum(-1, keepdim=True)
    return out.to(qkv.dtype).transpose(1, 2).reshape(b, s, n_embd)


def flash_attention_packed(qkv: torch.Tensor, n_heads: int, *,
                           causal: bool = False, dropout_rate: float = 0.0,
                           emit_stats: bool = False,
                           qkv_bias: "torch.Tensor | None" = None
                           ) -> torch.Tensor:
    """Attention over a packed, unbiased QKV projection: (B, S, 3D) → (B, S, D).

    ``qkv_bias`` (3D,) is added inside the kernel (zeros when None). A CUDA
    tensor launches K1 (bf16, head_dim 64, S ≤ 768, contiguous) or raises; a
    CPU tensor runs the plain version."""
    if dropout_rate > 0.0 or emit_stats:
        raise NotImplementedError(
            "attention dropout (the counter hash of vit_tpu/kernels/"
            "attention.py:_dropout_mask, :48-73) and the (m, l) statistics "
            "are training features, not ported yet")
    if qkv.ndim != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, S, 3D), got {tuple(qkv.shape)}")
    b, s, three_d = qkv.shape
    bias = (qkv_bias if qkv_bias is not None
            else torch.zeros(three_d, dtype=qkv.dtype, device=qkv.device))
    if bias.shape != (three_d,):
        raise ValueError(f"qkv_bias must be ({three_d},), got "
                         f"{tuple(bias.shape)}")
    if qkv.device.type == "cpu":
        return flash_attention_packed_ref(qkv, bias, n_heads, causal)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    n_embd = three_d // 3
    if not packed_supported(n_heads, n_embd, s):
        raise NotImplementedError(
            f"K1 takes head_dim {HEAD_DIM} and S <= {MAX_SEQ}; got "
            f"{n_heads} heads of width {n_embd}, S {s}. The unpacked "
            "attention kernel K6 (vit_tpu/kernels/attention.py:_fa_kernel) "
            "is not ported yet")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"K1 takes bf16 qkv, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("K1 takes a contiguous, 16-byte aligned qkv")
    bias = bias.to(torch.bfloat16).contiguous()
    if bias.device != qkv.device:
        raise ValueError(f"qkv_bias on {bias.device}, qkv on {qkv.device}")
    if bias.data_ptr() % 16:  # the kernel reads it 8 values at a time
        bias = bias.clone()
    out = torch.empty(b, s, n_embd, dtype=torch.bfloat16, device=qkv.device)
    lib = _build.load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.attention_packed_fwd(qkv.data_ptr(), bias.data_ptr(),
                                       out.data_ptr(), b, s, n_heads,
                                       int(causal), stream)
    _build.check(lib, err, "attention_packed_fwd")
    global launches
    launches += 1
    return out
