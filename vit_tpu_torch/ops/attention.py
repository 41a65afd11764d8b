"""Multi-head attention: the plain reference and the dispatch to the kernels
(counterpart of ``vit_tpu/ops/attention.py:25-141``).

Layout is (B, H, S, D) for ``attention_ref`` and ``multi_head_attention``,
and the packed (B, S, 3D) projection, columns ``(three h d)``, for
``fused_qkv_attention``.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.kernels.attention import (flash_attention,
                                             flash_attention_packed,
                                             merge_heads, packed_supported,
                                             split_heads)


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


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False) -> torch.Tensor:
    """Attention over q, k, v (B, H, S, D) through ``flash_attention``: K6,
    with K7/K8 in the backward, at every S. The JAX package hands S > 8192
    to XLA only because its kernels hold K and V in VMEM; these walk 64-row
    tiles and take any S."""
    return flash_attention(q, k, v, causal=causal)


def fused_qkv_attention(qkv: torch.Tensor, n_heads: int, *,
                        causal: bool = False,
                        qkv_bias: "torch.Tensor | None" = None) -> torch.Tensor:
    """Attention straight off the packed, unbiased QKV projection:
    (B, S, 3D) → (B, S, D), with ``qkv_bias`` (3D,) added before the product.

    A packed-supported shape goes to ``flash_attention_packed`` (K1/K2 on
    CUDA, their plain versions on the CPU). Any other shape adds the bias,
    splits the heads as strided views (no copies) and runs
    ``multi_head_attention``, whose output merges back for free."""
    _, s, three_d = qkv.shape
    if packed_supported(n_heads, three_d // 3, s):
        return flash_attention_packed(qkv, n_heads, causal=causal,
                                      qkv_bias=qkv_bias)
    q, k, v = split_heads(qkv, n_heads, qkv_bias)
    return merge_heads(multi_head_attention(q, k, v, causal=causal))
