"""The fp32 kernels' split products (``--mixed false``): the attention
kernels and the ConvNeXt tail's forward (K3). The port's plain split of an
fp32 value into three bf16 parts reassembles it exactly; plain emulations
of the kernels' arithmetic (every product the six bf16 products A_i·B_j,
i + j <= 2, small terms first, summed in fp32) hold the JAX package's fp32
kernels at Precision.HIGHEST within 1e-5: the forward's (scores taken
alike in both passes, each 64-key tile's P·V in a fresh accumulator, p
split whole, 1/l once at the end) against the packed forward with its
statistics and the unpacked one, the backward's (1/l folded into dv's A
operand) against ``jax.vjp`` of the packed attention, K3's (each 64-wide
tile's product in a fresh accumulator) against the Pallas tail. The
forward's emulation also holds the float64 forward within
``chip_smoke.F32_FWD_MEAN_REL``, the backward's the port's plain fp32
backward within ``chip_smoke.F32_BWD_MEAN_REL``, K3's the plain fp32 tail
within ``chip_smoke.SIMT_F32_MEAN_REL["K3"]`` and the float64 tail within
``chip_smoke.F32_TAIL_MEAN_REL``; and a split that lost its third part (the
operands rounded to x0 + x1) exceeds each mean limit held against float64
or the plain backward, so the limits tell the two apart. K10's fp32 form
(dW = gᵀ·x and db = Σ g, the split product over 32-row atoms of N in
fresh accumulators, fixed-order split partials) is held against the JAX
package's ``matmul_dw_db`` and the float64 dW within
``chip_smoke.F32_FCGRAD_MEAN_REL``, which its two-part control fails. The
bf16 K10's order (every k16 step of a split's 32-row atoms chained in one
accumulator, db in four row sets, the splits added in order) is held
against the JAX package's bf16 ``matmul_dw_db`` within
``chip_smoke.K10_DW_MEAN_REL`` / ``K10_DB_MEAN_REL`` at ragged N."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import smoke_constant, tail_inputs
from vit_tpu.kernels.attention import _packed_fwd_impl
from vit_tpu.kernels.attention import flash_attention as jax_unpacked
from vit_tpu.kernels.attention import flash_attention_packed as jax_packed
from vit_tpu.kernels import ln_matmul as jax_lnmm
from vit_tpu.kernels.convnext_block import \
    frozen_convnext_block_tail as jax_tail
from vit_tpu.kernels import fc_grad as jax_fc
from vit_tpu_torch.bench_kernels import (exact_attention_fwd, exact_fc_grad,
                                         exact_ln_matmul_fwd, exact_tail_bwd,
                                         exact_tail_fwd, two_part_fc_grad,
                                         two_part_ln_matmul_fwd,
                                         two_part_tail_bwd, two_part_tail_fwd,
                                         two_parts)
from vit_tpu_torch.kernels import attention as k_attn
from vit_tpu_torch.kernels import convnext_block as k_cnx
from vit_tpu_torch.kernels import fc_grad as k_fc
from vit_tpu_torch.kernels import ln_matmul as k_lnmm
from vit_tpu_torch.ops.gelu import gelu_grad, tanh_erf_gelu

FP32_REL = 1e-5   # the fp32 forms' limit on max and mean |Δ| / |reference|
F32_BWD_MEAN_REL = smoke_constant("F32_BWD_MEAN_REL")
F32_FWD_MEAN_REL = smoke_constant("F32_FWD_MEAN_REL")
# the SIMT forms' mean limits, which K3's and K4's fp32 forms are held to
# as well
SIMT_F32_MEAN_REL = next(
    ast.literal_eval(node.value)
    for node in ast.parse((Path(__file__).resolve().parents[1]
                           / "chip_smoke.py").read_text()).body
    if isinstance(node, ast.Assign)
    and getattr(node.targets[0], "id", None) == "SIMT_F32_MEAN_REL")
K3_F32_MEAN_REL = SIMT_F32_MEAN_REL["K3"]
K4_F32_MEAN_REL = SIMT_F32_MEAN_REL["K4"]
F32_TAIL_MEAN_REL = smoke_constant("F32_TAIL_MEAN_REL")
F32_TAIL_BWD_MEAN_REL = smoke_constant("F32_TAIL_BWD_MEAN_REL")
F32_LNMM_MEAN_REL = smoke_constant("F32_LNMM_MEAN_REL")
F32_FCGRAD_MEAN_REL = smoke_constant("F32_FCGRAD_MEAN_REL")
K10_DW_MEAN_REL = smoke_constant("K10_DW_MEAN_REL")
K10_DB_MEAN_REL = smoke_constant("K10_DB_MEAN_REL")
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


def test_split_weights_ref_lays_out_both_weights():
    """K3 fp32's pre-split, plain: (2, 3, 4C·C) bf16, W1's parts then W2's,
    each reassembling its weight exactly, the first part bf16(w); the
    wrapper of the CUDA pass refuses a CPU tensor."""
    g = torch.Generator().manual_seed(0)
    w1, w2 = torch.randn(384, 96, generator=g), torch.randn(96, 384,
                                                           generator=g)
    parts = k_cnx.split_weights_ref(w1, w2)
    assert parts.shape == (2, 3, 4 * 96 * 96)
    for i, w in enumerate((w1, w2)):
        assert torch.equal(parts[i].float().sum(0), w.reshape(-1))
        assert torch.equal(parts[i, 0], w.reshape(-1).bfloat16())
    with pytest.raises(ValueError, match="unsupported device"):
        k_cnx.split_weights(w1, w2)


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


def _split_tail_fwd(h, x, lns, lnb, w1, b1, w2, b2, gamma, eps):
    """K3's fp32 arithmetic (csrc/convnext_tail.cu, kParts = 3) in plain
    torch, w1 (4C, C) and w2 (C, 4C) in the Linear layout: u, W1, W2 and
    each chunk's a = gelu(z + b1) split into three bf16 parts; for each
    64-column chunk of 4C, z sums over the 64-wide atoms of C, each atom's
    six products in a fresh fp32 accumulator added to z; then each atom of
    o (64 output columns) adds that chunk's six products a·W2ᵀ, taken in a
    fresh accumulator; y = x + γ·(o + b2)."""
    c = h.shape[1]
    mu = h.mean(-1, keepdim=True)
    d = h - mu
    u = d * torch.rsqrt((d * d).mean(-1, keepdim=True) + eps) * lns + lnb
    pu, pw1, pw2 = (k_attn.split3(t) for t in (u, w1, w2))
    atoms = range(0, c, 64)   # C 96: the second atom has 32 columns
    o = [torch.zeros(h.shape[0], min(64, c - a0)) for a0 in atoms]
    for f0 in range(0, 4 * c, 64):
        z = torch.zeros(h.shape[0], 64)
        for a0 in atoms:
            tile = torch.zeros_like(z)
            for i, j in TERMS:
                tile = tile + (pu[i][:, a0:a0 + 64].float()
                               @ pw1[j][f0:f0 + 64, a0:a0 + 64].float().t())
            z = z + tile
        pa = k_attn.split3(tanh_erf_gelu(z + b1[f0:f0 + 64]))
        for k, a0 in enumerate(atoms):
            tile = torch.zeros_like(o[k])
            for i, j in TERMS:
                tile = tile + (pa[i].float()
                               @ pw2[j][a0:a0 + 64, f0:f0 + 64].float().t())
            o[k] = o[k] + tile
    return x + gamma * (torch.cat(o, -1) + b2)


def _tail_case(n, c):
    """tail_inputs as fp32 tensors, the weights in the Linear layout, and
    the JAX package's fp32 tail (Precision.HIGHEST) on them."""
    v = tail_inputs(n, c, seed=n + c)
    names = ("lns", "lnb", "w1", "b1", "w2", "b2", "gamma")
    y_j = torch.from_numpy(np.array(jax_tail(
        *(jnp.asarray(v[k]) for k in ("h", "x") + names))))
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    t["w1"], t["w2"] = t["w1"].t().contiguous(), t["w2"].t().contiguous()
    return (t["h"], t["x"], *(t[k] for k in names), 1e-6), y_j


def _split_tail_bwd(h, dy, lns, lnb, w1, b1, w2, gamma, eps):
    """K4's fp32 arithmetic (csrc/convnext_tail.cu, kParts = 3) in plain
    torch, w1 (4C, C) and w2 (C, 4C) in the Linear layout: u, do = γ⊙dy,
    W1, W2 and each chunk's dz split into three bf16 parts; for each
    64-column chunk of 4C, da = do·W2 and z = u·W1ᵀ sum over the 64-wide
    atoms of C, each atom's six products in a fresh fp32 accumulator added
    to the sum; dz = da⊙gelu′(z + b1); then each atom of du (64 columns of
    C) adds that chunk's six products dz·W1, taken in a fresh accumulator;
    then the LN backward in fp32."""
    c = h.shape[1]
    mu = h.mean(-1, keepdim=True)
    d = h - mu
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    uhat = d * rstd
    pu, pdo, pw1, pw2 = (k_attn.split3(t) for t in (uhat * lns + lnb,
                                                     dy * gamma, w1, w2))
    atoms = range(0, c, 64)   # C 96: the second atom has 32 columns

    def atom_sum(pa, pb, f0, transposed):
        out = torch.zeros(h.shape[0], 64)
        for a0 in atoms:
            tile = torch.zeros_like(out)
            for i, j in TERMS:
                b = (pb[j][f0:f0 + 64, a0:a0 + 64].float().t() if transposed
                     else pb[j][a0:a0 + 64, f0:f0 + 64].float())
                tile = tile + pa[i][:, a0:a0 + 64].float() @ b
            out = out + tile
        return out

    du = [torch.zeros(h.shape[0], min(64, c - a0)) for a0 in atoms]
    for f0 in range(0, 4 * c, 64):
        da = atom_sum(pdo, pw2, f0, False)
        z = atom_sum(pu, pw1, f0, True)
        pdz = k_attn.split3(da * gelu_grad(z + b1[f0:f0 + 64]))
        for k, a0 in enumerate(atoms):
            tile = torch.zeros_like(du[k])
            for i, j in TERMS:
                tile = tile + (pdz[i].float()
                               @ pw1[j][f0:f0 + 64, a0:a0 + 64].float())
            du[k] = du[k] + tile
    dhat = torch.cat(du, -1) * lns
    return rstd * (dhat - dhat.mean(-1, keepdim=True)
                   - uhat * (dhat * uhat).mean(-1, keepdim=True))


def _tail_bwd_case(n, c):
    """tail_inputs as fp32 tensors, the weights in the Linear layout, and
    dh of the JAX package's fp32 tail (its VJP, Precision.HIGHEST)."""
    v = tail_inputs(n, c, seed=n + c)
    names = ("lns", "lnb", "w1", "b1", "w2", "b2", "gamma")
    jp = {k: jnp.asarray(a) for k, a in v.items()}
    _, vjp = jax.vjp(lambda h: jax_tail(h, jp["x"], *(jp[k] for k in names)),
                     jp["h"])
    dh_j = torch.from_numpy(np.array(vjp(jp["dy"])[0]))
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    t["w1"], t["w2"] = t["w1"].t().contiguous(), t["w2"].t().contiguous()
    return (t["h"], t["dy"], *(t[k] for k in names if k != "b2"), 1e-6), dh_j


@pytest.mark.parametrize("c", [96, 192, 384])
def test_split_product_tail_bwd_matches_jax(c):
    """K4 fp32's emulation against the JAX package's fp32 tail gradient
    (``_bwd_impl``) within 1e-5 of max and mean |JAX|; as chip_smoke.py
    holds the kernel, against the port's plain fp32 backward within 1e-5 of
    max |plain| and SIMT_F32_MEAN_REL["K4"] of mean |plain|, and against
    the float64 backward within F32_TAIL_BWD_MEAN_REL of mean |exact|."""
    args, dh_j = _tail_bwd_case(70, c)
    got = _split_tail_bwd(*args)
    max_rel, mean_rel = _rel(got, dh_j)
    assert max_rel <= FP32_REL and mean_rel <= FP32_REL, (max_rel, mean_rel)
    max_rel, mean_rel = _rel(got, k_cnx.convnext_tail_bwd_ref(*args))
    assert max_rel <= FP32_REL and mean_rel <= K4_F32_MEAN_REL, (max_rel,
                                                                 mean_rel)
    assert _rel(got, exact_tail_bwd(*args))[1] <= F32_TAIL_BWD_MEAN_REL


@pytest.mark.parametrize("c", [96, 192, 384])
def test_two_part_tail_bwd_control_exceeds_the_mean_limit(c):
    """The backward with u, do, dz and the weights rounded to two bf16
    parts (``bench_kernels.two_part_tail_bwd``) misses the float64 backward
    by more than F32_TAIL_BWD_MEAN_REL of mean |exact|, so that limit tells
    a split that lost its third part from K4 fp32."""
    args, _ = _tail_bwd_case(70, c)
    assert _rel(two_part_tail_bwd(*args), exact_tail_bwd(*args))[1] \
        > F32_TAIL_BWD_MEAN_REL


# 70: two 64-row blocks, the second ragged
@pytest.mark.parametrize("c", [96, 192, 384])
def test_split_product_tail_matches_jax(c):
    """K3 fp32's emulation against the JAX package's fp32 tail within 1e-5
    of max and mean |JAX|; as chip_smoke.py holds the kernel, against the
    port's plain fp32 tail within 1e-5 of max |plain| and
    SIMT_F32_MEAN_REL["K3"] of mean |plain|, and against the float64 tail
    within F32_TAIL_MEAN_REL of mean |exact|."""
    args, y_j = _tail_case(70, c)
    got = _split_tail_fwd(*args)
    max_rel, mean_rel = _rel(got, y_j)
    assert max_rel <= FP32_REL and mean_rel <= FP32_REL, (max_rel, mean_rel)
    max_rel, mean_rel = _rel(got, k_cnx.convnext_tail_fwd_ref(*args))
    assert max_rel <= FP32_REL and mean_rel <= K3_F32_MEAN_REL, (max_rel,
                                                                 mean_rel)
    assert _rel(got, exact_tail_fwd(*args))[1] <= F32_TAIL_MEAN_REL


@pytest.mark.parametrize("c", [96, 192, 384])
def test_two_part_tail_control_exceeds_the_mean_limit(c):
    """The tail with u, a and the weights rounded to two bf16 parts (a
    16-bit significand, ``bench_kernels.two_part_tail_fwd``) misses the
    float64 tail by more than F32_TAIL_MEAN_REL of mean |exact|, so that
    limit tells a split that lost its third part from K3 fp32. (Against the
    plain fp32 tail it reads below SIMT_F32_MEAN_REL["K3"], which cannot
    tell them apart.)"""
    args, _ = _tail_case(70, c)
    assert _rel(two_part_tail_fwd(*args), exact_tail_fwd(*args))[1] \
        > F32_TAIL_MEAN_REL


def _split_ln_matmul(x, w, b, gelu):
    """K9a fp32's arithmetic (csrc/ln_matmul.cu, kParts = 3) in plain torch,
    w (F, C) in the Linear layout: x̂ from the row pre-pass's plain version
    with its three bf16 parts, W split likewise; for each 64-wide atom of C
    the six products of the parts, small terms first, in a fresh fp32
    accumulator added to the sum; then the bias, and at fc1 zpre = the sum
    and z = its GELU. (z, zpre or None, x̂)."""
    xhat, px = k_lnmm.ln_rows_ref(x)
    pw = k_attn.split3(w)
    acc = torch.zeros(x.shape[0], w.shape[0])
    for a0 in range(0, x.shape[1], 64):
        tile = torch.zeros_like(acc)
        for i, j in TERMS:
            tile = tile + (px[i][:, a0:a0 + 64].float()
                           @ pw[j][:, a0:a0 + 64].float().t())
        acc = acc + tile
    if b is not None:
        acc = acc + b
    if not gelu:
        return acc, None, xhat
    return tanh_erf_gelu(acc), acc, xhat


def _lnmm_case(c, act, f=256):
    """fp32 x (70, C) with an offset, W (F, C), b: 70 rows, one 128-row
    tile's 64-row halves, the second ragged."""
    rng = np.random.default_rng(c + act)
    x = (3 * rng.normal(size=(70, c)) + 1).astype(np.float32)
    w = (rng.normal(size=(f, c)) * c ** -0.5).astype(np.float32)
    b = (0.3 * rng.normal(size=(f,))).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(w),
            torch.from_numpy(b) if act else None, act)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_rows_ref_matches_jax_stats(dtype):
    """K9a's row pre-pass, plain: x̂ as ``ln_matmul._stats`` gives it,
    rounded to the compute dtype; for fp32 rows three bf16 parts that
    reassemble the fp32 x̂ exactly, the first part bf16(x̂). The CUDA pass's
    wrapper refuses a CPU tensor."""
    rng = np.random.default_rng(3)
    x = (2 * rng.normal(size=(70, 384)) + 0.5).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    xhat, parts = k_lnmm.ln_rows_ref(xt)
    ref, _ = jax_lnmm._stats(jnp.asarray(xt.float().numpy()))
    ref = torch.from_numpy(np.array(ref))
    assert xhat.dtype == dtype
    if dtype == torch.bfloat16:
        assert parts is None
        diff = (xhat.float() - ref.bfloat16().float()).abs()
        assert diff.max().item() <= 2.0 ** -7 * ref.abs().max().item()
    else:
        np.testing.assert_allclose(xhat.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert parts.shape == (3, 70, 384) and parts.dtype == torch.bfloat16
        assert torch.equal(parts.float().sum(0), xhat)
        assert torch.equal(parts[0], xhat.bfloat16())
    with pytest.raises(ValueError, match="unsupported device"):
        k_lnmm.ln_rows(xt)


@pytest.mark.parametrize("c, act", [(256, False), (256, True), (512, False),
                                    (512, True)])
def test_split_product_ln_matmul_matches_jax(c, act):
    """K9a fp32's emulation against the JAX package's fp32 ``_fwd_impl``
    (Precision.HIGHEST, interpret mode) within 1e-5 of max and mean |JAX|:
    z, zpre and x̂; as chip_smoke.py holds the kernel, against the port's
    plain fp32 K9a within 1e-5 of max |plain| and SIMT_F32_MEAN_REL["K9a"]
    of mean |plain|, and against the float64 K9a within F32_LNMM_MEAN_REL
    of mean |exact|."""
    x, w, b, gelu = _lnmm_case(c, act)
    bj = jnp.asarray(b.numpy()) if act else jnp.zeros(w.shape[0])
    got = _split_ln_matmul(x, w, b, gelu)
    z_j, zpre_j, xhat_j = (torch.from_numpy(np.array(t)) for t in
                           jax_lnmm._fwd_impl(jnp.asarray(x.numpy()),
                                              jnp.asarray(w.numpy().T), bj,
                                              act=gelu, has_bias=act))
    pairs = [(got[0], z_j), (got[2], xhat_j)] + ([(got[1], zpre_j)] if gelu
                                                 else [])
    for out, ref in pairs:
        max_rel, mean_rel = _rel(out, ref)
        assert max_rel <= FP32_REL and mean_rel <= FP32_REL, (max_rel,
                                                              mean_rel)
    plain = k_lnmm.ln_matmul_fwd_ref(x, w, b, gelu)
    max_rel, mean_rel = _rel(got[0], plain[0])
    assert max_rel <= FP32_REL and mean_rel <= SIMT_F32_MEAN_REL["K9a"], (
        max_rel, mean_rel)
    exact = exact_ln_matmul_fwd(x, w, b, gelu)
    assert _rel(got[0], exact[0])[1] <= F32_LNMM_MEAN_REL
    if gelu:
        assert _rel(got[1], exact[1])[1] <= F32_LNMM_MEAN_REL


@pytest.mark.parametrize("c, act", [(256, False), (256, True), (512, False),
                                    (512, True)])
def test_two_part_ln_matmul_control_exceeds_the_mean_limit(c, act):
    """K9a with x̂ and W rounded to two bf16 parts
    (``bench_kernels.two_part_ln_matmul_fwd``) misses the float64 K9a by
    more than F32_LNMM_MEAN_REL of mean |exact|, so that limit tells a
    split that lost its third part from K9a fp32."""
    x, w, b, gelu = _lnmm_case(c, act)
    assert _rel(two_part_ln_matmul_fwd(x, w, b, gelu)[0],
                exact_ln_matmul_fwd(x, w, b, gelu)[0])[1] > F32_LNMM_MEAN_REL


def _split_fc_grad(g, x, splits, atom=32, sets=8):
    """K10 fp32's arithmetic (csrc/fc_grad.cu: fc_grad_split_kernel, kParts
    = 3) in plain torch on g (N, F_out), x (N, F_in): N cut into ``splits``
    parts of whole 32-row atoms; in each part every atom's six products of
    the three bf16 parts of gᵀ and x, small terms first, in a fresh fp32
    accumulator added to the part's sum; db from the fp32 g, each of the 8
    row sets of an atom (rows ≡ r mod 8) summed in row order over the
    part's atoms, then the sets in order; the parts' partials added in
    order (sum_splits)."""
    pg, px = k_attn.split3(g), k_attn.split3(x)
    n, per = g.shape[0], -(-(-(-g.shape[0] // atom)) // splits) * atom
    dw = db = None
    for r0 in range(0, splits * per, per):
        part = torch.zeros(g.shape[1], x.shape[1])
        acc = torch.zeros(sets, g.shape[1])
        for a0 in range(r0, min(r0 + per, n), atom):
            rows = slice(a0, min(a0 + atom, n))
            tile = torch.zeros_like(part)
            for i, j in TERMS:
                tile = tile + pg[i][rows].float().t() @ px[j][rows].float()
            part = part + tile
            for k in range(0, atom, sets):
                for r in range(sets):
                    if a0 + k + r < n:
                        acc[r] = acc[r] + g[a0 + k + r]
        pdb = acc[0]
        for r in range(1, sets):
            pdb = pdb + acc[r]
        dw = part if dw is None else dw + part
        db = pdb if db is None else db + pdb
    return dw, db


def _fc_case(fo, fi, n=1001):
    """fp32 g (N, F_out) and x (N, F_in), N ragged against the 32-row atoms
    (1001 = 31 · 32 + 9), and the split count the wrapper takes for them
    on 132 SMs."""
    rng = np.random.default_rng(fo + fi)
    g = torch.from_numpy(rng.normal(size=(n, fo)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, fi)).astype(np.float32))
    return g, x, k_fc.splits_f32(n, (fo // 128) * (fi // 128), 132)


@pytest.mark.parametrize("fo, fi", [(128, 512), (512, 128)])
def test_split_product_fc_grad_matches_jax(fo, fi):
    """K10 fp32's emulation, at an fc2-like (g narrower than x) and an
    fc1-like shape with a ragged N, against the JAX package's fp32
    ``matmul_dw_db`` (interpret mode, db over g) within 1e-5 of max and
    mean |JAX|; as chip_smoke.py holds the kernel, against the port's plain
    K10 within FP32_REL and against the float64 dW within
    F32_FCGRAD_MEAN_REL of mean |exact|."""
    g, x, splits = _fc_case(fo, fi)
    assert splits > 1
    dw, db = _split_fc_grad(g, x, splits)
    dw_j, db_j = (torch.from_numpy(np.array(t)) for t in jax_fc.matmul_dw_db(
        jnp.asarray(g.numpy()), jnp.asarray(x.numpy()), db_operand=0))
    for out, ref in ((dw, dw_j), (db, db_j), *zip((dw, db),
                                                  k_fc.matmul_dw_db_ref(g, x))):
        max_rel, mean_rel = _rel(out, ref)
        assert max_rel <= FP32_REL and mean_rel <= FP32_REL, (max_rel, mean_rel)
    exact = exact_fc_grad(g, x)
    assert _rel(dw, exact[0])[1] <= F32_FCGRAD_MEAN_REL
    assert _rel(db, exact[1])[1] <= FP32_REL


@pytest.mark.parametrize("fo, fi", [(128, 512), (512, 128)])
def test_two_part_fc_grad_control_exceeds_the_mean_limit(fo, fi):
    """K10 with g and x rounded to two bf16 parts
    (``bench_kernels.two_part_fc_grad``) misses the float64 dW by more
    than F32_FCGRAD_MEAN_REL of mean |exact|, so that limit tells a split
    that lost its third part from K10 fp32; the emulation with two parts
    a product (i + j <= 1, what a kernel that dropped a part computes)
    misses it too."""
    g, x, splits = _fc_case(fo, fi)
    exact = exact_fc_grad(g, x)[0]
    assert _rel(two_part_fc_grad(g, x)[0], exact)[1] > F32_FCGRAD_MEAN_REL
    pg, px = (k_attn.split3(t) for t in (g, x))
    two = sum(pg[i].float().t() @ px[j].float() for i, j in TERMS if i + j <= 1)
    assert _rel(two, exact)[1] > F32_FCGRAD_MEAN_REL


def test_fc_grad_f32_splits_fill_whole_waves():
    """The fp32 form's split count (``kernels/fc_grad.py:splits_f32``): a
    block holds an SM, so at the flagship's 144 dW tiles on 132 SMs it
    cuts N into 11 parts, 1584 blocks in 12 full waves; never more parts
    than one per 8 atoms of N, nor more than 16; 1 where the tiles alone
    fill the waves."""
    assert k_fc.splits_f32(20480, 144, 132) == 11
    assert k_fc.splits_f32(20481, 144, 132) == 11
    assert k_fc.splits_f32(777, 144, 132) <= 4
    assert k_fc.splits_f32(100, 144, 132) == 1
    assert k_fc.splits_f32(20480, 264, 132) == 1
    assert all(k_fc.splits_f32(n, t, 132) <= 16
               for n in (64, 5000, 10 ** 6) for t in (1, 7, 144, 500))


def _rows_per_split(n, splits, atom):
    """The rows of a split: whole ``atom``-row atoms, ceil over the splits
    (csrc/fc_grad.cu's launcher)."""
    return -(-(-(-n // atom)) // splits) * atom


def _bf16_fc_grad(g, x, splits, atom=32, sets=4):
    """The bf16 K10's order (csrc/fc_grad.cu: fc_grad_bf16_kernel) in plain
    torch on bf16 g (N, F_out), x (N, F_in): N cut into ``splits`` parts of
    whole 32-row atoms (the ring's stages, kAtom1); in each part one fp32
    accumulator carried over every k16 step of every atom in order, acc =
    acc + g[k16]ᵀ·x[k16] (wgmma m64n256k16, chained; rows past N are zero);
    db from the bf16 g, each of the 4 row sets (rows ≡ r mod 4: a half warp
    each) summed in row order over the part, then the sets in order; the
    parts added into dW and db in split order, (((p0 + p1) + p2) + ...)
    (store1)."""
    g32, x32 = g.float(), x.float()
    n = g.shape[0]
    per = _rows_per_split(n, splits, atom)
    dw = db = None
    for r0 in range(0, splits * per, per):
        acc = torch.zeros(g.shape[1], x.shape[1])
        for k0 in range(r0, min(r0 + per, n), 16):
            rows = slice(k0, min(k0 + 16, n))
            acc = acc + g32[rows].t() @ x32[rows]
        part = torch.zeros(sets, g.shape[1])
        for row in range(r0, min(r0 + per, n)):
            part[row % sets] += g32[row]
        pdb = part[0]
        for k in range(1, sets):
            pdb = pdb + part[k]
        dw = acc if dw is None else dw + acc
        db = pdb if db is None else db + pdb
    return dw, db


@pytest.mark.parametrize("fo, fi, n", [
    pytest.param(128, 512, 1001, id="128-512"),
    pytest.param(512, 128, 1001, id="512-128"),
    pytest.param(128, 512, 600, id="128-512-600"),
    pytest.param(512, 128, 600, id="512-128-600")])
def test_bf16_fc_grad_order_matches_jax(fo, fi, n):
    """The bf16 K10's emulation at an fc2-like (g narrower than x) and an
    fc1-like shape, at N 1001 and 600 (ragged against the 32-row atoms, in
    the split count the wrapper takes on 132 SMs at these widths; at N 600
    the splits of 32-row atoms end at other rows than 64-row atoms would
    give), against the JAX package's ``matmul_dw_db(..., db_operand=0)`` on
    the same bf16 operands (interpret mode) and the port's plain K10,
    within the limits chip_smoke.py holds the kernel to: max 1e-3 (dW) and
    1e-4 (db) of max |reference|, K10_DW_MEAN_REL / K10_DB_MEAN_REL of mean
    |reference|."""
    rng = np.random.default_rng(fo + 2 * fi + n)
    g = torch.from_numpy(rng.normal(size=(n, fo)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, fi)).astype(np.float32))
    g, x = g.bfloat16(), x.bfloat16()
    splits = k_fc.splits_bf16(n, k_fc.tiles_bf16(fo, fi), 132)
    assert splits > 1
    if n == 600:
        assert (_rows_per_split(n, splits, 32)
                != _rows_per_split(n, splits, 64))
    dw, db = _bf16_fc_grad(g, x, splits)
    refs = [tuple(torch.from_numpy(np.array(t, dtype=np.float32))
                  for t in jax_fc.matmul_dw_db(
                      jnp.asarray(g.float().numpy(), dtype=jnp.bfloat16),
                      jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16),
                      db_operand=0)),
            k_fc.matmul_dw_db_ref(g, x)]
    for dw_ref, db_ref in refs:
        for out, ref, max_lim, mean_lim in ((dw, dw_ref, 1e-3, K10_DW_MEAN_REL),
                                            (db, db_ref, 1e-4, K10_DB_MEAN_REL)):
            max_rel, mean_rel = _rel(out, ref)
            assert max_rel <= max_lim and mean_rel <= mean_lim, (max_rel,
                                                                 mean_rel)


@pytest.mark.parametrize("n, tiles, splits", [
    (20480, 72, 5), (20481, 72, 5), (1001, 72, 1), (100, 72, 1),
    (20480, 264, 1), (5000, 72, 3), (10 ** 6, 72, 11), (1001, 2, 4)])
def test_fc_grad_bf16_splits(n, tiles, splits):
    """The bf16 form's split count (``kernels/fc_grad.py:splits_bf16``),
    the fewest waves of one block an SM for the rows they carry, each wave
    WAVE_ROWS rows dearer: at the flagship's 72 dW tiles of 128 × 256
    (fc1 and fc2 alike) on 132 SMs N 20480 takes 5 parts (3 waves; the
    split counts timed on an H100 put 3 and 5 first, 11 whole waves
    last but one), ragged N alike; a tiny N or tiles that fill the waves
    alone take 1; never more parts than 16 or one per 256 rows."""
    assert k_fc.tiles_bf16(768, 3072) == k_fc.tiles_bf16(3072, 768) == 72
    assert k_fc.splits_bf16(n, tiles, 132) == splits
    assert 1 <= splits <= min(16, max(1, -(-n // 256)))
