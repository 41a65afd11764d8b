"""Port parity for the int8 perceptual path (``--perceptual_quant int8``):
the quantization helpers bit for bit, ``frozen_int8_dense``, the int8
ConvNeXt tail's plain versions (K12a/K12b) against the Pallas kernels and
their VJP in interpret mode, the tiny ConvNeXt under ``dw_impl="pallas"``
and ``quant="int8"`` against the JAX one, and one train step of the slice."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.kernels.convnext_block as jax_cnx
from torch_port_helpers import (CONVNEXT, TINY_FUSED_DIM, configs,
                                convnext_params, images, jax_params,
                                jax_perceptual, jax_train_step, port_model,
                                port_perceptual, scaled_err,
                                smoke_constant, tail_inputs, tiny_preset,
                                with_gamma)
from vit_tpu.core import quant as jax_quant
from vit_tpu.models.titok import TiTok as JaxTiTok
from vit_tpu_torch.bridge import convnext_state_dict_from_flax
from vit_tpu_torch.core import quant
from vit_tpu_torch.kernels import convnext_block as k_cnx
from vit_tpu_torch.losses.perceptual import ConvNeXt
from vit_tpu_torch.ops.gelu import gelu_grad, tanh_erf_gelu
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState
from vit_tpu_torch.train.step import make_tokenizer_train_step

# frozen_int8_dense: the same quantized integers, rescaled in the same fp32
# order; only the fp32 bias add and the cast may round apart.
DENSE_TOL = 1e-4
# The int8 tail against the Pallas kernel: the LN statistics round apart at
# the ulp, which may move an activation across a rounding boundary of its
# int8 level (1/127 of the row's absmax): fp32 within 1e-3 of max |JAX|;
# bf16 rounds the rows to 2^-8 on top.
TAIL_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
# Through the whole tiny ConvNeXt in fp32: dw_impl="pallas" holds the golden
# 1e-3 contract (measured: logits 2.6e-7, loss 3.1e-7, image gradient
# 8.2e-7); int8 quantizes every pointwise product of 4 blocks, and a level
# flipped early travels through the net: 1e-2 (measured: logits 1.4e-3 and
# 1.5e-3, loss 1.2e-3 and 4.1e-4, gradient 5.8e-3 and 5.6e-3 without and
# with dw_impl="pallas").
DW_TOL, INT8_TOL = 1e-3, 1e-2
# One fp32 step of the slice, as tests/test_torch_train.py holds it.
STEP_TOL = 1e-3


def _ties(rows: int, cols: int, seed: int) -> np.ndarray:
    """fp32 rows whose absmax is 127 · 2^e and whose other entries sit
    between int8 levels, some exactly on .5 ties."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-120, 120, size=(rows, cols))
    v[:, ::3] = np.round(v[:, ::3]) + 0.5                 # exact ties
    v[:, 1] = 127.0 * rng.choice([-1.0, 1.0], rows)       # absmax 127
    v *= np.exp2(rng.integers(-6, 6, size=(rows, 1)))
    return v.astype(np.float32)


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "normal"])
def test_quant_helpers_are_bit_identical_to_jax(ties):
    """quant_rows, quant_cols, quantize_kernel and int8_matmul: the same
    scales, the same int8 values (ties rounded to even) and the same fp32
    products as the JAX package, on inputs with exact .5 ties and on normal
    ones."""
    rng = np.random.default_rng(5)

    def make(rows, cols, seed):
        if ties:
            return _ties(rows, cols, seed)
        return rng.normal(size=(rows, cols)).astype(np.float32)

    v = make(24, 48, seed=0)
    q, s = k_cnx.quant_rows(torch.from_numpy(v))
    q_j, s_j = jax_cnx._quant_rows(jnp.asarray(v))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    if ties:   # the ties are real ties of the row scale, rounded to even
        ratio = v / s.numpy()
        tie = ratio - np.floor(ratio) == 0.5
        assert tie.sum() > 50
        assert (q.numpy()[tie] % 2 == 0).all()

    w = make(48, 40, seed=1).T.copy()                     # columns hold ties
    q, s = k_cnx.quant_cols(torch.from_numpy(w))
    q_j, s_j = jax_cnx._quant_cols(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))

    kq, ks = quant.quantize_kernel(torch.from_numpy(w))
    kq_j, ks_j = jax_quant.quantize_kernel(jnp.asarray(w))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kq_j))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(ks_j))
    if ties:
        ratio = w / ks.numpy()
        assert (ratio - np.floor(ratio) == 0.5).sum() > 50
    else:   # · (1/127) and / 127 round apart somewhere: each keeps its form
        assert not np.array_equal(ks.numpy(), s.numpy())

    x = make(5, 40, seed=2)
    y = quant.int8_matmul(torch.from_numpy(x), kq, ks)
    y_j = jax_quant.int8_matmul(jnp.asarray(x), kq_j, ks_j)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_int8_dense_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 96)) / 8).astype(np.float32)
    b = rng.normal(size=(96,)).astype(np.float32)
    dy = rng.normal(size=(2, 6, 96)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    y_j, vjp = jax.vjp(lambda x_: jax_quant.frozen_int8_dense(
        x_, jnp.asarray(w), jnp.asarray(b)), jx)
    (dx_j,) = vjp(jnp.asarray(dy))

    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tw, tb = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    y = quant.frozen_int8_dense(tx, tw, tb)
    y.backward(torch.from_numpy(dy))
    assert y.dtype == torch.float32 and tx.grad.dtype == tx.dtype
    assert scaled_err(y.detach(), y_j) < DENSE_TOL
    assert scaled_err(tx.grad.float(), jnp.asarray(dx_j, jnp.float32)) \
        < DENSE_TOL
    assert tw.grad is None and tb.grad is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# 13: a ragged tile; 70 at the CUDA kernels' widths: a 64-row block and a
# ragged one
@pytest.mark.parametrize("n,c", [(40, 32), (13, 64), (70, 96), (70, 192),
                                 (70, 384)])
def test_int8_tail_matches_jax(n, c, dtype):
    v = tail_inputs(n, c, seed=n + c)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(a) for k, a in v.items()}
    names = ("lns", "lnb", "w1", "b1", "w2", "b2", "gamma")
    y_j, vjp = jax.vjp(lambda h, x: jax_cnx.frozen_convnext_block_tail(
        h, x, *(jp[k] for k in names), quant="int8"),
        jp["h"].astype(jdt), jp["x"].astype(jdt))
    dh_j, dx_j = vjp(jp["dy"].astype(jdt))

    tp = {k: torch.from_numpy(a) for k, a in v.items()}
    tp["w1"], tp["w2"] = tp["w1"].T, tp["w2"].T   # PyTorch's Linear layout
    h = tp["h"].to(tdt).requires_grad_()
    x = tp["x"].to(tdt).requires_grad_()
    dy = tp["dy"].to(tdt)
    y = k_cnx.frozen_convnext_block_tail(h, x, *(tp[k] for k in names),
                                         quant="int8")
    dh, dx = torch.autograd.grad(y, (h, x), dy)
    assert y.dtype == dh.dtype == tdt
    tol = TAIL_TOL[dtype]
    assert scaled_err(y.detach().float(), y_j) < tol
    assert scaled_err(dh.float(), dh_j) < tol
    assert torch.equal(dx, dy)
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(dx_j, np.float32))
    # the int8 path is engaged: neither output is the bf16/fp32 tail's
    params = [tp[k] for k in names]
    assert not torch.equal(y, k_cnx.convnext_tail_fwd_ref(
        h.detach(), x.detach(), *params, 1e-6))
    assert not torch.equal(dh, k_cnx.convnext_tail_bwd_ref(
        h.detach(), dy, *(tp[k] for k in names if k != "b2"), 1e-6))


def test_k12a_levels_without_division_match_rint_of_the_quotient():
    """K12a's level (csrc/convnext_tail_q8.cu) rounds t = v·fl(1/s) and
    takes the IEEE division only where near_half flags t within 4e-5 of a
    half-integer: in fp32 that gives quant_rows' level rint(fl(v / s)) on
    random rows of many scales and on values made to fall on ties."""
    near = float(re.search(r"> (0\.[0-9]+)f;", _q8_source()).group(1))
    rng = np.random.default_rng(3)
    v = rng.normal(0, 1, (512, 1536)).astype(np.float32)
    v[:256] *= np.float32(10.0) ** rng.uniform(-3, 3, (256, 1)).astype(
        np.float32)
    s = (np.abs(v).max(-1, keepdims=True) * np.float32(1 / 127)).astype(
        np.float32)
    ties = ((rng.integers(-127, 127, (512, 64)) + np.float32(0.5))
            * s).astype(np.float32)
    v = np.concatenate([v, ties], -1)
    t = v * (np.float32(1) / s)
    r = np.rint(t)
    slow = np.abs(t - r) > np.float32(near)
    r = np.where(slow, np.rint(v / s), r)
    assert slow.any() and np.array_equal(r, np.rint(v / s))
    q8, s8 = k_cnx.quant_rows(torch.from_numpy(v))
    assert np.array_equal(s8.numpy(), s)
    assert np.array_equal(np.clip(r, -127, 127), q8.numpy())


def test_k12a_gelu_absmax_from_two_candidates_or_every_element():
    """K12a's pass 1 (csrc/convnext_tail_q8.cu: fwd::GeluAbsMax) takes a
    row's largest |gelu(z)| from GELU at two of its z, the largest and the
    smallest, and where that reads below kFlat, the max over every element
    (fwd::exact_absmax). With the port's fp32 tanh-erf GELU that equals
    the max over every element on every row: normal, all negative, far
    past the clamp of u, and wholly at GELU's flat minimum, where
    neighbouring z round their GELUs apart (there four candidates, the two
    nearest GELU's minimum besides, could read an ulp or two low). kFlat
    lies above |gelu| everywhere below z = 0.27."""
    flat = float(re.search(r"kFlat = ([0-9.]+)f;", _q8_source()).group(1))
    grid = torch.linspace(-8.0, 0.27, 2_000_001)
    assert tanh_erf_gelu(grid).abs().max() < flat
    rng = np.random.default_rng(0)
    rows = [rng.normal(0, 2, (256, 384)), -np.abs(rng.normal(0, 2, (64, 384))),
            rng.uniform(-2, 0, (64, 384)),
            -np.exp(rng.uniform(0, 40, (64, 384))),
            rng.normal(0, 1, (64, 384)) * np.where(
                rng.random((64, 384)) < 0.01, 1e8, 1.0),
            rng.uniform(-0.8, -0.7, (64, 384)),   # at the flat minimum
            rng.uniform(-1.5, 0.27, (64, 384))]
    z = torch.from_numpy(np.concatenate(rows).astype(np.float32))
    want = tanh_erf_gelu(z).abs().amax(-1)
    top, lowest = z.amax(-1), z.amin(-1)
    got = torch.maximum(
        torch.where(top > 0, tanh_erf_gelu(top), torch.zeros_like(top)),
        tanh_erf_gelu(lowest).abs())
    low = got < flat
    assert low[-128:].all() and not low[:256].any()
    got = torch.where(low, want, got)
    assert torch.equal(got, want)


def _levels(v, s):
    """The kernels' int8 levels of v at scale s (csrc/convnext_tail_q8.cu:
    level, near_half): rint(v·fl(1/s)), the IEEE quotient where that lies
    within the source's near_half bound of a half-integer; clipped to
    ±127. int8."""
    near = float(re.search(r"> (0\.[0-9]+)f;", _q8_source()).group(1))
    t = v * torch.reciprocal(s)
    r = torch.round(t)
    r = torch.where((t - r).abs() > near, torch.round(v / s), r)
    return r.clamp(-127, 127).to(torch.int8)


def _quant_rows_k12(v):
    """quant_rows as the kernels take it: the same scale, the levels by
    :func:`_levels`."""
    s = v.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    return _levels(v, s), s


def _k12b_two_pass(h, dy, lns, lnb, w1, b1, w2, gamma, eps, chunk=128):
    """K12b's order (csrc/convnext_tail_q8.cu, namespace bwd) in plain torch,
    w1 (4C, C) and w2 (C, 4C) in the Linear layout: uq and doq by the
    division-free levels; pass 1 over chunks of 4C columns forms z, da and
    dz = da·gelu′(z) (the plain version's roundings), keeps the running row
    absmax of |dz| and stores dz; pass 2 takes the stored dz's levels with
    the row scale and sums du = dzq·W1ᵀq chunk by chunk in int32; then the
    LN backward. (dh, the chunked absmax, the stored dz, dzq)."""
    dt = h.dtype
    lns, lnb, b1, gamma = (p.to(dt).float() for p in (lns, lnb, b1, gamma))
    w1q, w1s = k_cnx.quant_cols(w1.t())
    w1tq, w1ts = k_cnx.quant_cols(w1)
    w2tq, w2ts = k_cnx.quant_cols(w2)
    uhat, rstd = k_cnx._normalize(h, eps)
    uq, us = _quant_rows_k12(uhat * lns + lnb)
    doq, dos = _quant_rows_k12(dy.float() * gamma)
    amax, stored = torch.zeros(h.shape[0], 1), []
    for f0 in range(0, w1.shape[0], chunk):
        f = slice(f0, f0 + chunk)
        z = (uq.long() @ w1q[:, f].long()).float() * us * w1s[f] + b1[f]
        da = (doq.long() @ w2tq[:, f].long()).float() * dos * w2ts[f]
        dz = da * gelu_grad(z)
        amax = torch.maximum(amax, dz.abs().amax(-1, keepdim=True))
        stored.append(dz)
    s = amax.clamp_min(1e-8) * (1.0 / 127.0)
    du = torch.zeros(h.shape, dtype=torch.int32)
    dzq = []
    for f0, dz in zip(range(0, w1.shape[0], chunk), stored):
        dzq.append(_levels(dz, s))
        du += (dzq[-1].long() @ w1tq[f0:f0 + chunk].long()).int()
    dhat = du.float() * s * w1ts * lns
    c1 = dhat.mean(-1, keepdim=True)
    c2 = (dhat * uhat).mean(-1, keepdim=True)
    dh = (rstd * (dhat - c1 - uhat * c2)).to(dt)
    return dh, amax, torch.cat(stored, -1), torch.cat(dzq, -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c", [(13, 64), (70, 96)])
def test_k12b_two_pass_order_matches_the_plain_version_and_jax(n, c, dtype):
    """K12b's two-pass order (:func:`_k12b_two_pass`, chunks of 128 of the
    4C columns) at a small C: the chunked absmax of dz is quant_rows'
    absmax over the whole row, to the bit; pass 2's levels of the stored dz
    are rint(dz / s) clipped to ±127 on every element, and dzq, dz and dh
    equal the plain version's (``convnext_tail_bwd_q8_ref``) to the bit;
    that dh holds ``jax.vjp`` of the Pallas tail with quant="int8"
    (interpret mode) within the tail's tolerance."""
    v = tail_inputs(n, c, seed=2 * n + c)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tp = {k: torch.from_numpy(a) for k, a in v.items()}
    w1, w2 = tp["w1"].T, tp["w2"].T   # PyTorch's Linear layout
    h, dy = tp["h"].to(tdt), tp["dy"].to(tdt)
    args = (h, dy, tp["lns"], tp["lnb"], w1, tp["b1"], w2, tp["gamma"], 1e-6)
    dh, amax, dz, dzq = _k12b_two_pass(*args)
    # the plain version's dz and its quantization over the whole row
    lns, lnb, b1, gamma = (tp[k].to(tdt).float()
                           for k in ("lns", "lnb", "b1", "gamma"))
    uhat, _ = k_cnx._normalize(h, 1e-6)
    uq, us = k_cnx.quant_rows(uhat * lns + lnb)
    w1q, w1s = k_cnx.quant_cols(w1.t())
    w2tq, w2ts = k_cnx.quant_cols(w2)
    doq, dos = k_cnx.quant_rows(dy.float() * gamma)
    z = torch._int_mm(uq, w1q).float() * us * w1s + b1
    dz_ref = torch._int_mm(doq, w2tq).float() * dos * w2ts * gelu_grad(z)
    dzq_ref, dzs_ref = k_cnx.quant_rows(dz_ref)
    assert torch.equal(dz, dz_ref)
    assert torch.equal(amax, dz_ref.abs().amax(-1, keepdim=True))
    assert torch.equal(amax.clamp_min(1e-8) * (1.0 / 127.0), dzs_ref)
    assert torch.equal(dzq, dzq_ref)
    assert torch.equal(dzq.float(), torch.round(dz / dzs_ref).clamp(-127, 127))
    assert torch.equal(dh, k_cnx.convnext_tail_bwd_q8_ref(*args))
    jp = {k: jnp.asarray(a) for k, a in v.items()}
    names = ("lns", "lnb", "w1", "b1", "w2", "b2", "gamma")
    _, vjp = jax.vjp(lambda hh, xx: jax_cnx.frozen_convnext_block_tail(
        hh, xx, *(jp[k] for k in names), quant="int8"),
        jp["h"].astype(jdt), jp["x"].astype(jdt))
    dh_j, _ = vjp(jp["dy"].astype(jdt))
    assert scaled_err(dh.float(), dh_j) < TAIL_TOL[dtype]


def test_k12b_levels_at_near_half_quotients_match_rint_of_the_quotient():
    """K12b's pass 2 takes dz's levels as K12a's (:func:`_levels`): on
    rows of dz whose quotients dz / s are made to fall within 2^-17 of a
    half-integer, on both sides and on it, the rule takes its IEEE
    quotient and gives rint(fl(dz / s)) clipped to ±127 on every element,
    the levels of ``quant_rows``."""
    rng = np.random.default_rng(11)
    rows, cols = 256, 512
    s = (np.float32(2.0) ** rng.integers(-20, 4, (rows, 1))
         * rng.uniform(1, 2, (rows, 1))).astype(np.float32)
    k = rng.integers(-127, 127, (rows, cols)).astype(np.float32)
    off = rng.choice([-2.0 ** -17, -2.0 ** -20, 0.0, 2.0 ** -20, 2.0 ** -17],
                     (rows, cols)).astype(np.float32)
    dz = ((k + np.float32(0.5) + off) * s).astype(np.float32)
    dz[:, 0] = np.float32(127.0) * s[:, 0]   # the row's absmax: s exactly
    dz = torch.from_numpy(dz)
    q, scale = _quant_rows_k12(dz)
    q_ref, s_ref = k_cnx.quant_rows(dz)
    assert torch.equal(scale, s_ref)
    t = dz * torch.reciprocal(scale)
    assert ((t - torch.round(t)).abs() > 0.49996).float().mean() > 0.5
    assert torch.equal(q, q_ref)
    assert torch.equal(q.float(),
                       torch.round(dz / scale).clamp(-127, 127))


def _q8_source() -> str:
    return (Path(k_cnx.__file__).resolve().parents[1] / "csrc"
            / "convnext_tail_q8.cu").read_text()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_tensor_scale_control_exceeds_the_mean_limit(dtype, monkeypatch):
    """chip_smoke.py's control of Q8_MEAN_REL, the plain K12a and K12b with
    one scale for each activation operand in place of per-row scales,
    misses the plain versions by more than the limit of mean |plain|
    here too."""
    limit = smoke_constant("Q8_MEAN_REL")
    v = tail_inputs(40, 32, seed=5)
    tp = {k: torch.from_numpy(a) for k, a in v.items()}
    tp["w1"], tp["w2"] = tp["w1"].T, tp["w2"].T   # PyTorch's Linear layout
    h, x, dy = (tp[k].to(getattr(torch, dtype)) for k in ("h", "x", "dy"))
    p = [tp[k] for k in ("lns", "lnb", "w1", "b1", "w2")]
    fwd = (h, x, *p, tp["b2"], tp["gamma"], 1e-6)
    bwd = (h, dy, *p, tp["gamma"], 1e-6)
    refs = (k_cnx.convnext_tail_fwd_q8_ref(*fwd),
            k_cnx.convnext_tail_bwd_q8_ref(*bwd))

    def per_tensor(v32):
        s = v32.abs().amax().clamp_min(1e-8).reshape(1, 1) * (1.0 / 127.0)
        return torch.round(v32 / s).clamp(-127, 127).to(torch.int8), s

    monkeypatch.setattr(k_cnx, "quant_rows", per_tensor)
    got = (k_cnx.convnext_tail_fwd_q8_ref(*fwd),
           k_cnx.convnext_tail_bwd_q8_ref(*bwd))
    for out, ref in zip(got, refs):
        rel = ((out.double() - ref.double()).abs().mean()
               / ref.double().abs().mean()).item()
        assert rel > limit


def test_int8_tail_refuses_an_unknown_quant_and_a_device_tensor():
    v = tail_inputs(8, 16, seed=1)
    tp = {k: torch.from_numpy(a) for k, a in v.items()}
    names = ("lns", "lnb", "w1", "b1", "w2", "b2", "gamma")
    tp["w1"], tp["w2"] = tp["w1"].T, tp["w2"].T
    with pytest.raises(ValueError, match="quant"):
        k_cnx.frozen_convnext_block_tail(tp["h"], tp["x"],
                                         *(tp[k] for k in names), quant="fp8")
    meta = torch.empty(8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k_cnx.convnext_tail_fwd_q8(meta, meta, *(tp[k] for k in names))
    with pytest.raises(ValueError, match="unsupported device"):
        k_cnx.convnext_tail_bwd_q8(meta, meta,
                                   *(tp[k] for k in names if k != "b2"))
    assert k_cnx.q8_launches == 0 and k_cnx.q8_bwd_launches == 0


@pytest.fixture(scope="module")
def params():
    return with_gamma(convnext_params())


# (dw_impl, quant, tolerance): each switch alone and both together
SWITCHES = [("pallas", "none", DW_TOL), ("lax", "int8", INT8_TOL),
            ("pallas", "int8", INT8_TOL)]


class _LogitSpy:
    """Stands in for the JAX loss's flax model and keeps the logits of each
    ``apply``, so one jitted program yields the loss, its image gradient
    and the logits (each program compiles the interpret-mode kernels anew,
    which is most of these tests' time)."""

    def __init__(self, model):
        self.model, self.seen = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def apply(self, variables, img):
        out = self.model.apply(variables, img)
        self.seen.append(out)
        return out


@pytest.mark.parametrize("dw_impl,qmode,tol", SWITCHES)
def test_tiny_convnext_matches_jax(params, dw_impl, qmode, tol, monkeypatch):
    """The logits of the resized image, the perceptual loss and its image
    gradient. Both packages fuse the tails up to C 64 and run the last stage
    (C 128) unfused, the JAX side through its Pallas kernels in interpret
    mode (``mlp_impl="fused"``)."""
    monkeypatch.setattr(k_cnx, "MAX_FUSED_DIM", TINY_FUSED_DIM)
    monkeypatch.setattr(jax_cnx, "MAX_FUSED_DIM", TINY_FUSED_DIM)
    loss_j = jax_perceptual(params, mlp_impl="fused", dw_impl=dw_impl,
                            quant=qmode)
    spy = loss_j.model = _LogitSpy(loss_j.model)

    @jax.jit
    def loss_grad_logits(x, y):
        spy.seen.clear()
        (loss, logits), g = jax.value_and_grad(
            lambda x_: (loss_j(x_, y), spy.seen[0]), has_aux=True)(x)
        return loss, g, logits

    rng = np.random.default_rng(6)
    x, y = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    ref, g_ref, logits_j = loss_grad_logits(jnp.asarray(x), jnp.asarray(y))
    loss_t = port_perceptual(params, dw_impl=dw_impl, quant=qmode)
    tx = torch.from_numpy(x).requires_grad_()
    out = loss_t(tx, torch.from_numpy(y))
    (g,) = torch.autograd.grad(out, tx)
    with torch.no_grad():
        img = loss_t._prep(torch.from_numpy(x))
        logits = loss_t.net(img)
        plain = port_perceptual(params).net(img)
    assert logits.shape == (2, CONVNEXT["num_classes"])
    assert scaled_err(logits, logits_j) < tol
    np.testing.assert_allclose(out.item(), float(ref), rtol=tol)
    assert scaled_err(g.numpy(), g_ref) < tol
    # the switch changed the arithmetic: the default net gives other logits
    assert not torch.equal(plain, logits)


def test_one_flax_tree_loads_for_every_switch(params):
    """The switches change the arithmetic, not the parameters: the bridge
    maps the same flax tree onto every combination."""
    ref = ConvNeXt(**CONVNEXT)
    ref.load_state_dict(convnext_state_dict_from_flax(params, ref))
    for dw_impl in ("lax", "pallas"):
        for qmode in ("none", "int8"):
            net = ConvNeXt(**CONVNEXT, dw_impl=dw_impl, quant=qmode)
            net.load_state_dict(convnext_state_dict_from_flax(params, net))
            assert all(torch.equal(a, b) for a, b in
                       zip(net.state_dict().values(),
                           ref.state_dict().values()))
    with pytest.raises(ValueError, match="quant"):
        ConvNeXt(**CONVNEXT, quant="int4")


def test_int8_train_step_matches_jax(params, monkeypatch):
    """The slice as a whole: one fp32 step of the tokenizer train step with
    the tiny TiTok and the int8 tiny ConvNeXt (γ around 0.5) against the
    jitted JAX step; the same codes, metrics within 1e-3 relative."""
    monkeypatch.setattr(k_cnx, "MAX_FUSED_DIM", TINY_FUSED_DIM)
    monkeypatch.setattr(jax_cnx, "MAX_FUSED_DIM", TINY_FUSED_DIM)
    for var in ("VIT_TPU_FUSED_LN", "VIT_TPU_FUSED_FC"):
        monkeypatch.delenv(var, raising=False)
    opt = dict(lr=1e-4, warmup_steps=1, train_steps=1000, min_lr=1e-5,
               weight_decay=1e-4, clip_norm=1.0)
    with tiny_preset():
        cfg_j, cfg_t = configs("float32")
        tparams = jax_params(cfg_j)
        net_j = JaxTiTok(cfg_j)
        model = port_model(cfg_t, tparams).train().requires_grad_(True)
    step_j, create = jax_train_step(
        net_j, jax_perceptual(params, mlp_impl="fused", quant="int8"), **opt)
    state_j = create(jax.tree.map(jnp.asarray, tparams))
    usage_j = jnp.zeros((cfg_j.codebook_size,))
    state = TrainState.create(model, make_optimizer(**opt))
    usage = torch.zeros(cfg_t.codebook_size)
    step = make_tokenizer_train_step(
        model, perceptual_loss_fn=port_perceptual(params, quant="int8"))
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "convnext_tail_fwd_q8"),
                      ("bwd", "convnext_tail_bwd_q8")):
        def spy(*args, _fn=getattr(k_cnx, name), _key=key):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(k_cnx, name, spy)
    x = images(4, seed=40)
    idx_j = net_j.apply({"params": state_j.params}, jnp.asarray(x),
                        method=net_j.encode)
    with torch.no_grad():
        idx = model.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _, usage_j, m_j, _ = step_j(state_j, jnp.asarray(x), usage_j,
                                jax.random.PRNGKey(0))
    _, usage, m, _ = step(state, torch.from_numpy(x), usage)
    np.testing.assert_array_equal(usage.numpy(), np.asarray(usage_j))
    assert set(m) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(m[k].item(), float(m_j[k]), rtol=STEP_TOL,
                                   atol=1e-6, err_msg=k)
    # the int8 tails ran: 3 fused blocks for both images, the backward for x
    assert calls == {"fwd": 6, "bwd": 3}, calls
