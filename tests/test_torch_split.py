"""The fp32 attention kernels' split products (``--mixed false``): the
port's plain split of an fp32 value into three bf16 parts reassembles it
exactly; plain emulations of the kernels' arithmetic (every product the
six bf16 products A_i·B_j, i + j <= 2, small terms first, summed in fp32)
hold the JAX package's fp32 kernels at Precision.HIGHEST within 1e-5: the
forward's (scores taken alike in both passes, each 64-key tile's P·V in a
fresh accumulator, p split whole, 1/l once at the end) against the packed
forward with its statistics and the unpacked one, the backward's (1/l
folded into dv's A operand) against ``jax.vjp`` of the packed attention.
The forward's emulation also holds the float64 forward within
``chip_smoke.F32_FWD_MEAN_REL``, the backward's the port's plain fp32
backward within ``chip_smoke.F32_BWD_MEAN_REL``; and a split that lost its
third part (the operands rounded to x0 + x1) exceeds each mean limit, so
the limits tell the two apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import smoke_constant
from vit_tpu.kernels.attention import _packed_fwd_impl
from vit_tpu.kernels.attention import flash_attention as jax_unpacked
from vit_tpu.kernels.attention import flash_attention_packed as jax_packed
from vit_tpu_torch.bench_kernels import exact_attention_fwd, two_parts
from vit_tpu_torch.kernels import attention as k_attn

FP32_REL = 1e-5   # the fp32 forms' limit on max and mean |Δ| / |reference|
F32_BWD_MEAN_REL = smoke_constant("F32_BWD_MEAN_REL")
F32_FWD_MEAN_REL = smoke_constant("F32_FWD_MEAN_REL")
# (A part, B part) of the six products, small terms first (hopper.cuh)
TERMS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split3_reassembles_fp32_exactly(seed):
    """x0 + x1 + x2 == x in fp32 over seeded normal values whose magnitudes
    span 1e-30 to 1e30 (below about 2⁻¹¹⁰ the third part leaves bf16's
    normal range), each part a bf16 below the last by 2⁻⁸ or more."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=20000) * 10.0 ** rng.uniform(
        -30, 30, 20000)).astype(np.float32))
    x0, x1, x2 = k_attn.split3(x)
    assert x0.dtype == x1.dtype == x2.dtype == torch.bfloat16
    assert torch.equal(x0.float() + x1.float() + x2.float(), x)
    assert torch.equal(x0.float() + (x1.float() + x2.float()), x)
    assert bool((x1.float().abs() <= 2.0 ** -8 * x.abs()).all())
    assert bool((x2.float().abs() <= 2.0 ** -16 * x.abs()).all())


def test_split_parts_ref_lays_out_the_biased_operands():
    """The pre-split's plain version: (4, B, H, S, 3, 64), q, k and v with
    their parts of the packed (3D,) bias added, dO as it is."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 3, 5, 64, generator=g) for _ in range(4))
    bias = torch.randn(3 * 3 * 64, generator=g)
    parts = k_attn.split_parts_ref(q, k, v, do, bias)
    assert parts.shape == (4, 2, 3, 5, 3, 64)
    bq, bk, bv = bias.view(3, 3, 1, 64)
    for i, x in enumerate((q + bq, k + bk, v + bv, do)):
        assert torch.equal(parts[i].float().sum(-2), x)
        assert torch.equal(parts[i][..., 0, :], x.bfloat16())


def _split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of fp32 operands as the kernels take it: the six products of
    their bf16 parts, small terms first, summed in fp32."""
    pa, pb = k_attn.split3(a), k_attn.split3(b)
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for i, j in TERMS:
        out = out + pa[i].float() @ pb[j].float()
    return out


def _split_fwd(q, k, v, causal):
    """The fp32 forward's arithmetic (csrc/attention_fwd.cu, kParts = 3) in
    plain torch: (o, m, l) from (B, H, S, 64) fp32 operands. Pass 1 takes
    the row max over each 64-key tile's scores, pass 2 takes the same
    scores again, p = exp(s − m) and l = Σ p unrounded, and each tile's P·V
    in a fresh accumulator added to o; o is divided by l once."""
    n = q.shape[-2]
    tiles = range(0, n, 64)

    def scores(k0):
        s = _split_mm(q, k[..., k0:k0 + 64, :].transpose(-1, -2)) * 0.125
        if causal:
            col = torch.arange(k0, min(k0 + 64, n))
            s = s.masked_fill(col > torch.arange(n)[:, None], float("-inf"))
        return s

    m = torch.stack([scores(k0).amax(-1) for k0 in tiles]).amax(0)
    o = torch.zeros_like(q)
    l = torch.zeros_like(m)
    for k0 in tiles:
        p = torch.exp(scores(k0) - m[..., None])
        assert bool((p <= 1.0).all())   # the same scores as pass 1's
        l = l + p.sum(-1)
        o = o + _split_mm(p, v[..., k0:k0 + 64, :])
    return o / l[..., None], m, l


def _split_bwd(q, k, v, do, m, l, causal):
    """The fp32 backward's arithmetic (csrc/attention_bwd.cu, kParts = 3)
    in plain torch: (dq, dk, dv) from (B, H, S, 64) fp32 operands."""
    s = _split_mm(q, k.transpose(-1, -2)) * 0.125
    if causal:
        n = q.shape[-2]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(),
                          float("-inf"))
    ph = torch.exp(s - m[..., None])
    linv = 1.0 / l[..., None]
    dp = _split_mm(do, v.transpose(-1, -2))
    delta = (ph * dp).sum(-1, keepdim=True)
    ds = ph * ((dp - delta * linv) * (0.125 * linv))
    dv = _split_mm((ph * linv).transpose(-1, -2), do)
    return _split_mm(ds, k), _split_mm(ds.transpose(-1, -2), q), dv


def _inputs(s, seed, b=2, n_heads=2):
    rng = np.random.default_rng(seed)
    width = 64 * n_heads
    qkv = rng.normal(size=(b, s, 3 * width)).astype(np.float32)
    bias = (0.3 * rng.normal(size=(3 * width,))).astype(np.float32)
    g = rng.normal(size=(b, s, width)).astype(np.float32)
    return qkv, bias, g


def _packed(grads, b, s):
    """(dq, dk, dv) (B, H, S, 64) → dqkv (B, S, 3D) and the bias gradient."""
    g = torch.stack(grads)
    return (g.permute(1, 3, 0, 2, 4).reshape(b, s, -1),
            g.sum((1, 3)).reshape(-1))


def _rel(out: torch.Tensor, ref: torch.Tensor) -> "tuple[float, float]":
    diff = (out.double() - ref.double()).abs()
    return ((diff.max() / ref.double().abs().max()).item(),
            (diff.mean() / ref.double().abs().mean()).item())


def _case(s, causal):
    n_heads = 2
    qkv, bias, g = _inputs(s, seed=s + 5 * causal)
    b = qkv.shape[0]
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    _, m, l = k_attn.attention_packed_fwd(tq, tb, n_heads, causal,
                                          emit_stats=True)
    q, k, v = k_attn.split_heads(tq, n_heads, tb)
    do = torch.from_numpy(g).reshape(b, s, n_heads, 64).transpose(1, 2)
    return qkv, bias, g, (q, k, v, do, m, l), b, n_heads


def _jax_stats(stats, n_heads: int, s: int):
    """(m, l) (B, H, S) from the packed forward's residuals (h2, B, Sp,
    128): head h2·hb + j's m on lanes j·8, its l on lanes 64 + j·8."""
    stats = np.asarray(stats)
    hb = n_heads // stats.shape[0]
    m = [stats[h // hb, :, :s, (h % hb) * 8] for h in range(n_heads)]
    l = [stats[h // hb, :, :s, 64 + (h % hb) * 8] for h in range(n_heads)]
    return (torch.from_numpy(np.stack(m, 1)), torch.from_numpy(np.stack(l, 1)))


@pytest.mark.parametrize("s, causal", [(24, False), (24, True), (197, False),
                                       (197, True)])
def test_split_product_forward_matches_jax(s, causal):
    """The forward emulation's o, m and l against the JAX package's fp32
    forwards (Pallas at Precision.HIGHEST on the CPU): the packed one with
    its bias and statistics (K1's) and the unpacked one on the biased head
    views (K6's), within 1e-5 of max and mean |JAX|; against the float64
    forward within F32_FWD_MEAN_REL of mean |exact|, as chip_smoke.py holds
    the kernel; against the port's plain fp32 forward within 1e-5."""
    qkv, bias, _, (q, k, v, *_), b, n_heads = _case(s, causal)
    out_j, stats = _packed_fwd_impl(jnp.asarray(qkv), jnp.zeros((1,),
                                                                jnp.int32),
                                    n_heads, causal, 0.0,
                                    bias=jnp.asarray(bias), emit_stats=True)
    m_j, l_j = _jax_stats(stats, n_heads, s)
    o_k1 = torch.from_numpy(np.array(out_j)).reshape(b, s, n_heads,
                                                     64).transpose(1, 2)
    o_k6 = torch.from_numpy(np.array(jax_unpacked(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal)))
    got = _split_fwd(q, k, v, causal)
    for out, ref in zip(got + (got[0],), (o_k1, m_j, l_j, o_k6)):
        max_rel, mean_rel = _rel(out, ref)
        assert max_rel <= FP32_REL and mean_rel <= FP32_REL, (max_rel,
                                                              mean_rel)
    exact = exact_attention_fwd(q, k, v, causal)
    plain = k_attn.attention_fwd_ref(q, k, v, causal, True)
    for out, ex, ref in zip(got, exact, plain):
        assert _rel(out, ex)[1] <= F32_FWD_MEAN_REL
        max_rel, mean_rel = _rel(out, ref)
        assert max_rel <= FP32_REL and mean_rel <= FP32_REL


@pytest.mark.parametrize("s, causal", [(24, False), (24, True), (197, False),
                                       (197, True)])
def test_two_part_forward_control_exceeds_the_mean_limit(s, causal):
    """The plain fp32 forward on q, k and v rounded to two bf16 parts misses
    the float64 forward by more than F32_FWD_MEAN_REL of its mean |o|, |m|
    and |l|, as chip_smoke.py's control must."""
    _, _, _, (q, k, v, *_), _, _ = _case(s, causal)
    got = k_attn.attention_fwd_ref(*(two_parts(t) for t in (q, k, v)),
                                   causal, True)
    for out, ex in zip(got, exact_attention_fwd(q, k, v, causal)):
        assert _rel(out, ex)[1] > F32_FWD_MEAN_REL


@pytest.mark.parametrize("s, causal", [(24, False), (24, True), (197, False),
                                       (197, True)])
def test_split_product_backward_matches_jax(s, causal):
    """The emulation's dqkv and dbias against ``jax.vjp`` of the JAX
    package's packed attention in fp32 (its Pallas backward at
    Precision.HIGHEST on the CPU) within 1e-5 of max and mean |JAX|, and
    against the port's plain fp32 backward within F32_BWD_MEAN_REL of mean
    |plain|."""
    qkv, bias, g, (q, k, v, do, m, l), b, n_heads = _case(s, causal)
    _, vjp = jax.vjp(
        lambda x, bb: jax_packed(x, n_heads, causal=causal, qkv_bias=bb),
        jnp.asarray(qkv), jnp.asarray(bias))
    dqkv_j, dbias_j = (torch.from_numpy(np.array(t))
                       for t in vjp(jnp.asarray(g)))
    dqkv, dbias = _packed(_split_bwd(q, k, v, do, m, l, causal), b, s)
    for out, ref in ((dqkv, dqkv_j), (dbias, dbias_j)):
        max_rel, mean_rel = _rel(out, ref)
        assert max_rel <= FP32_REL and mean_rel <= FP32_REL, (max_rel,
                                                              mean_rel)
    plain = k_attn.attention_packed_bwd_ref(
        torch.from_numpy(qkv), torch.from_numpy(bias), torch.from_numpy(g),
        m, l, n_heads, causal)
    for out, ref in ((dqkv, plain[0]), (dbias, plain[1])):
        assert _rel(out, ref)[1] <= F32_BWD_MEAN_REL


@pytest.mark.parametrize("s, causal", [(24, False), (24, True), (197, False),
                                       (197, True)])
def test_two_part_control_exceeds_the_mean_limit(s, causal):
    """The plain backward on q, k, v and dO rounded to two bf16 parts (a
    16-bit significand, a split without its third part) misses the plain
    backward by more than F32_BWD_MEAN_REL of mean |plain| in each of dq,
    dk and dv, as chip_smoke.py's control must."""
    _, _, _, (q, k, v, do, m, l), _, _ = _case(s, causal)
    got = k_attn.attention_bwd_ref(*(two_parts(t) for t in (q, k, v, do)),
                                   m, l, causal)
    refs = k_attn.attention_bwd_ref(q, k, v, do, m, l, causal)
    for out, ref in zip(got, refs):
        assert _rel(out, ref)[1] > F32_BWD_MEAN_REL
