"""Multi-head attention: the plain reference and the packed-QKV dispatch
(counterpart of ``vit_tpu/ops/attention.py:25-118``).

Layout is (B, H, S, D) for ``attention_ref`` and the packed (B, S, 3D)
projection, columns ``(three h d)``, for ``fused_qkv_attention``.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.kernels.attention import (flash_attention_packed,
                                             packed_supported)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False) -> torch.Tensor:
    """Plain attention, the counterpart of ``attention_xla``. q, k, v:
    (B, H, S, D) → (B, H, S, D), scale 1/√D. Scores and softmax in fp32; the
    normalised probabilities are cast to v's dtype for the PV product."""
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        q_len, k_len = q.shape[-2], k.shape[-2]
        # causal over the aligned suffix: query i sees keys j <= i + (k_len - q_len)
        idx_q = torch.arange(q_len, device=q.device)[:, None]
        idx_k = torch.arange(k_len, device=q.device)[None, :]
        s = s.masked_fill(idx_k > idx_q + (k_len - q_len),
                          torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def fused_qkv_attention(qkv: torch.Tensor, n_heads: int, *,
                        causal: bool = False,
                        qkv_bias: "torch.Tensor | None" = None) -> torch.Tensor:
    """Attention straight off the packed, unbiased QKV projection:
    (B, S, 3D) → (B, S, D), with ``qkv_bias`` (3D,) added before the product.

    A packed-supported shape goes to ``flash_attention_packed`` (K1 on CUDA,
    its plain version on the CPU). Any other shape runs ``attention_ref`` on
    the CPU and raises on CUDA, where it needs K6, not ported yet."""
    b, s, three_d = qkv.shape
    n_embd = three_d // 3
    if packed_supported(n_heads, n_embd, s):
        return flash_attention_packed(qkv, n_heads, causal=causal,
                                      qkv_bias=qkv_bias)
    if qkv.device.type != "cpu":
        raise NotImplementedError(
            f"attention with {n_heads} heads of width {n_embd} at S {s} is "
            "not packed-supported; it needs the unpacked attention kernel K6 "
            "(vit_tpu/kernels/attention.py:_fa_kernel), not ported yet")
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.to(qkv.dtype)
    d = n_embd // n_heads
    q, k, v = qkv.reshape(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    out = attention_ref(q, k, v, causal=causal)
    return out.transpose(1, 2).reshape(b, s, n_embd)
