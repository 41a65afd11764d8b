"""Port parity for the fused transformer kernels: K9a/K9b/K9c (LayerNorm
fused into the qkv and fc1 products, and its backward) and K10 (the MLP
products' dW and db in one pass), through their plain versions, against the
JAX package's Pallas kernels in interpret mode and their ``jax.vjp``; the
gates that switch them on; and a tiny transformer with them on, against the
JAX transformer with the same switches."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.core.config as jax_config
from torch_port_helpers import TINY, count_plain_calls, smoke_constant
from vit_tpu.core.transformer import Transformer as JaxTransformer
from vit_tpu.core.transformer import _use_fused_fc, _use_fused_ln
from vit_tpu.kernels import fc_grad as jax_fc
from vit_tpu.kernels import ln_matmul as jax_lnmm
from vit_tpu_torch.bridge import _from_flax
from vit_tpu_torch.core.config import TransformerConfig
from vit_tpu_torch.core.transformer import (Transformer, use_fused_fc,
                                            use_fused_ln)
from vit_tpu_torch.kernels import fc_grad as k_fc
from vit_tpu_torch.kernels import ln_matmul as k_lnmm

C, F = 128, 384
FWD_TOL = 1e-5    # fp32 on both sides: only the summation order differs
GRAD_TOL = 1e-4   # gradients sum N more products
MODEL_TOL = 1e-3  # the repo's fp32 golden contract


def _smoke_limits(name: str):
    """A tuple or dict of limits of chip_smoke.py (``a, b = 1, 2`` or a
    dict literal), read from its source as ``smoke_constant`` reads one."""
    tree = ast.parse((Path(__file__).resolve().parents[1]
                      / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            names = [getattr(t, "id", None)
                     for t in getattr(target, "elts", [target])]
            if name in names:
                value = ast.literal_eval(node.value)
                return value[names.index(name)] if len(names) > 1 else value
    raise KeyError(name)


def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.normal(size=s)).astype(np.float32) for s in shapes]


def _as(arr, dtype):
    """The same numpy values as a (JAX array, torch tensor) pair in dtype."""
    return (jnp.asarray(arr, getattr(jnp, dtype)),
            torch.from_numpy(arr).to(getattr(torch, dtype)))


def _np(t):
    """A torch tensor or JAX array as fp32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def _assert_close(out, ref, dtype, tol=FWD_TOL):
    """fp32: within ``tol``; bf16: within one bf16 ulp of the larger value
    per element (one fp32 value rounded on either side of a bf16 boundary),
    plus 2^-17 of the largest |ref|: in the GELU's negative tail 1 + tanh
    cancels, and XLA's CPU tanh returns exactly ±1 beyond |x| ≈ 5 where
    torch's does not (measured: 6e-6 apart at outputs of order 3)."""
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
        return
    mag = np.maximum(np.abs(out), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bad = np.abs(out - ref) > ulp + 2.0 ** -17 * np.abs(ref).max()
    assert not bad.any(), (int(bad.sum()), np.abs(out - ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias,gelu", [(False, False), (True, False),
                                       (True, True)])
def test_ln_matmul_fwd_matches_pallas(bias, gelu, dtype):
    """K9a's plain version against ``_fwd_impl``: z, zpre and x̂, N 10
    (a ragged tile)."""
    x, w, b = _rng_arrays(0, (10, C), (C, F), (F,))
    w *= 0.1
    xj, xt = _as(x, dtype)
    wj, wt = _as(np.ascontiguousarray(w.T), dtype)   # the port's (F, C)
    bj, bt = _as(b if bias else np.zeros(F, np.float32), dtype)
    z_j, zpre_j, y_j = jax_lnmm._fwd_impl(xj, wj.T, bj, act=gelu,
                                          has_bias=bias)
    z, zpre, y = k_lnmm.ln_matmul_fwd(xt, wt, bt if bias else None, gelu)
    assert z.dtype == y.dtype == xt.dtype
    _assert_close(z, z_j, dtype)
    _assert_close(y, y_j, dtype)
    if gelu:
        _assert_close(zpre, zpre_j, dtype)
    else:
        assert zpre is None
    z_only = k_lnmm.ln_matmul_fwd(xt, wt, bt if bias else None, gelu,
                                  residuals=False)
    assert torch.equal(z_only[0], z) and z_only[1:] == (None, None)


@pytest.mark.parametrize("gelu", [False, True])   # the qkv and fc1 sites
def test_fused_ln_matmul_grads_match_jax(gelu):
    """``FusedLnMatmul`` against ``jax.vjp`` of ``fused_ln_matmul``, fp32:
    z, dx, dW and (at the fc1 site) db."""
    x, w, b, g = _rng_arrays(1, (2, 5, C), (C, F), (F,), (2, 5, F))
    w *= 0.1
    args = (jnp.asarray(x), jnp.asarray(w)) + ((jnp.asarray(b),) if gelu
                                               else ())
    z_j, vjp = jax.vjp(lambda *a: jax_lnmm.fused_ln_matmul(
        a[0], a[1], a[2] if gelu else None, gelu=gelu), *args)
    grads_j = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_() if gelu else None
    z = k_lnmm.fused_ln_matmul(tx, tw, tb, gelu=gelu)
    assert type(z.grad_fn).__name__ == "ViewBackward0"
    inputs = (tx, tw) + ((tb,) if gelu else ())
    grads = torch.autograd.grad(z, inputs, torch.from_numpy(g))
    _assert_close(z, z_j, "float32")
    _assert_close(grads[0], grads_j[0], "float32", GRAD_TOL)
    _assert_close(grads[1].T, grads_j[1], "float32", GRAD_TOL)
    if gelu:
        _assert_close(grads[2], grads_j[2], "float32", GRAD_TOL)
    with torch.no_grad():   # inference: K9a alone, the same z
        np.testing.assert_array_equal(
            k_lnmm.fused_ln_matmul(tx, tw, tb, gelu=gelu).numpy(), _np(z))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dgelu_matches_pallas(dtype):
    """K9b's plain version against ``_dgelu_impl``; N(0, 3) reaches past
    the tanh-erf clamp."""
    (zpre,) = _rng_arrays(2, (10, F), scale=3.0)
    (dz,) = _rng_arrays(12, (10, F))
    zj, zt = _as(zpre, dtype)
    dj, dt = _as(dz, dtype)
    _assert_close(k_lnmm.ln_matmul_dgelu(zt, dt),
                  jax_lnmm._dgelu_impl(zj, dj), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_bwd_matches_pallas(dtype):
    """K9c's plain version against ``_ln_bwd_impl``, rows with an offset so
    the mean matters."""
    x, g = _rng_arrays(3, (10, C), (10, C))
    x += 2.0
    xj, xt = _as(x, dtype)
    gj, gt = _as(g, dtype)
    _assert_close(k_lnmm.ln_bwd(xt, gt), jax_lnmm._ln_bwd_impl(xj, gj), dtype)


def _ln_bwd_paired(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K9c's arithmetic (csrc/ln_bwd.cu) in plain torch: x and g in fp32,
    two rounds of paired sums, (Σx, Σg) and then (Σd², Σg·d) with d = x − μ;
    rstd = rsqrt(Σd²/C + eps), c1 = Σg/C, c2 = rstd·Σg·d/C, and dx =
    rstd·(g − c1 − d·rstd·c2) rounded once to x's dtype."""
    x32, g32 = x.float(), g.float()
    c = x.shape[-1]
    mu = x32.sum(-1, keepdim=True) / c
    c1 = g32.sum(-1, keepdim=True) / c
    d = x32 - mu
    rstd = torch.rsqrt((d * d).sum(-1, keepdim=True) / c + k_lnmm.EPS)
    c2 = rstd * (g32 * d).sum(-1, keepdim=True) / c
    return (rstd * (g32 - c1 - (d * rstd) * c2)).to(x.dtype)


def _max_rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# 384: a bf16 row ends with an 8-byte step; 1024: the widest; 77 ragged
@pytest.mark.parametrize("n,c", [(77, 384), (20, 1024)])
def test_ln_bwd_paired_sums_match_pallas(n, c, dtype):
    """K9c's two rounds of paired sums against ``_ln_bwd_impl`` within the
    limits chip_smoke.py holds the kernel to: bf16 BWD_MAX_REL of max |ref|
    and BWD_MEAN_REL and LN_MEAN_REL of mean |ref|; fp32 FP32_REL on both
    and SIMT_F32_MEAN_REL["K9c"] on the mean."""
    x, g = _rng_arrays(n + c, (n, c), (n, c))
    x = 2.0 * x + 0.5
    xj, xt = _as(x, dtype)
    gj, gt = _as(g, dtype)
    got = _ln_bwd_paired(xt, gt)
    ref = torch.from_numpy(_np(jax_lnmm._ln_bwd_impl(xj, gj)))
    if dtype == "float32":
        max_tol = smoke_constant("FP32_REL")
        mean_tol = min(max_tol, _smoke_limits("SIMT_F32_MEAN_REL")["K9c"])
    else:
        max_tol = _smoke_limits("BWD_MAX_REL")
        mean_tol = min(_smoke_limits("BWD_MEAN_REL"),
                       smoke_constant("LN_MEAN_REL"))
    assert _max_rel(got, ref) <= max_tol
    assert _mean_rel(got, ref) <= mean_tol


@pytest.mark.parametrize("c", [200, 1152])
def test_ln_bwd_refuses_a_width_it_is_not_built_for(c):
    """A width that is not a multiple of 128 up to 1024 has no kernel: the
    wrapper raises before it looks for a device, and launches nothing; a
    CPU tensor of that width still runs the plain version."""
    meta = torch.empty(10, c, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="multiple of 128 up to 1024"):
        k_lnmm.ln_bwd(meta, meta)
    assert k_lnmm.ln_bwd_launches == 0
    x, g = (torch.from_numpy(a) for a in _rng_arrays(c, (10, c), (10, c)))
    assert torch.equal(k_lnmm.ln_bwd(x, g), k_lnmm.ln_bwd_ref(x, g))


def _mean_rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.double() - ref.double()).abs().mean()
            / ref.double().abs().mean()).item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_stats_control_exceeds_the_mean_limit(dtype, monkeypatch):
    """chip_smoke.py's control of LN_MEAN_REL, the plain K9a (fc1: bias and
    GELU) and K9c with the LayerNorm mean and 1/σ rounded to bf16, misses
    the plain versions by more than the limit of mean |plain| here too."""
    limit = smoke_constant("LN_MEAN_REL")
    x, w, b, g = _rng_arrays(6, (64, C), (F, C), (F,), (64, C))
    x = 3.0 * x + 1.0
    x, w, b, g = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (x, w / np.sqrt(C), b, g))
    refs = (k_lnmm.ln_matmul_fwd_ref(x, w, b, True)[0],
            k_lnmm.ln_bwd_ref(x, g))

    def bf16_stats(x32):
        mu = x32.mean(-1, keepdim=True).bfloat16().float()
        d = x32 - mu
        rstd = torch.rsqrt((d * d).mean(-1, keepdim=True)
                           + k_lnmm.EPS).bfloat16().float()
        return d * rstd, rstd

    monkeypatch.setattr(k_lnmm, "_stats", bf16_stats)
    got = (k_lnmm.ln_matmul_fwd_ref(x, w, b, True)[0],
           k_lnmm.ln_bwd_ref(x, g))
    for out, ref in zip(got, refs):
        assert _mean_rel(out, ref) > limit


@pytest.mark.parametrize("n", [256, 300])   # 300: a ragged last block
@pytest.mark.parametrize("db_operand", [0, 1])
def test_matmul_dw_db_matches_pallas(n, db_operand):
    """The port's one arrangement, (gᵀ·x, Σ g), against both of JAX's:
    ``db_operand=0`` on (g, x) and ``db_operand=1`` on (x, g), transposed.
    fp32, JAX's own tolerances."""
    g, x = _rng_arrays(4, (n, 128), (n, 384))
    dw, db = k_fc.matmul_dw_db(torch.from_numpy(g), torch.from_numpy(x))
    assert dw.dtype == db.dtype == torch.float32
    if db_operand == 0:
        dw_j, db_j = jax_fc.matmul_dw_db(jnp.asarray(g), jnp.asarray(x),
                                         db_operand=0)
    else:
        dwt_j, db_j = jax_fc.matmul_dw_db(jnp.asarray(x), jnp.asarray(g),
                                          db_operand=1)
        dw_j = dwt_j.T
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), rtol=1e-5,
                               atol=1e-4)


def test_matmul_dw_db_bf16_matches_pallas():
    """bf16 operands, fp32 results: the same products summed in another
    order."""
    g, x = _rng_arrays(5, (512, 128), (512, 256))
    gj, gt = _as(g, "bfloat16")
    xj, xt = _as(x, "bfloat16")
    dw, db = k_fc.matmul_dw_db(gt, xt)
    dw_j, db_j = jax_fc.matmul_dw_db(gj, xj, db_operand=0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("cin,cout", [(128, 512), (512, 128)])  # fc1, fc2
def test_fused_dense_matches_jax(cin, cout):
    """``FusedDense`` against ``jax.vjp`` of ``fused_dense``: y, dx, dW,
    db, fp32."""
    x, w, b, g = _rng_arrays(6, (2, 40, cin), (cin, cout), (cout,),
                             (2, 40, cout))
    w *= 0.02
    y_j, vjp = jax.vjp(jax_fc.fused_dense, jnp.asarray(x), jnp.asarray(w),
                       jnp.asarray(b))
    dx_j, dw_j, db_j = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = k_fc.fused_dense(tx, tw, tb)
    dx, dw, db = torch.autograd.grad(y, (tx, tw, tb), torch.from_numpy(g))
    _assert_close(y, y_j, "float32")
    _assert_close(dx, dx_j, "float32", GRAD_TOL)
    _assert_close(dw.T, dw_j, "float32", GRAD_TOL)
    _assert_close(db, db_j, "float32", GRAD_TOL)


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor runs a plain version; a meta tensor stands in for
    a device here."""
    meta = dict(device="meta")
    x, w = torch.empty(10, C, **meta), torch.empty(F, C, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        k_lnmm.ln_matmul_fwd(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        k_lnmm.ln_matmul_dgelu(torch.empty(10, F, **meta),
                               torch.empty(10, F, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        k_lnmm.ln_bwd(x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        k_fc.matmul_dw_db(x, torch.empty(10, F, **meta))
    with pytest.raises(ValueError, match="do not fit"):
        k_lnmm.ln_matmul_fwd(x, torch.empty(C, F, **meta))
    assert (k_lnmm.launches, k_lnmm.dgelu_launches, k_lnmm.ln_bwd_launches,
            k_fc.launches) == (0, 0, 0, 0)


def _gate_configs(width, value):
    kw = dict(n_layers=1, n_heads=2, n_embd=width, block_size=8,
              fused_ln=value, fused_fc_grad=value)
    return jax_config.TransformerConfig(**kw), TransformerConfig(**kw)


@pytest.mark.parametrize("cfg_value", [None, True, False])
@pytest.mark.parametrize("env", [None, "0", "1", "qkv", "mlp"])
def test_fused_ln_gate_matches_jax(env, cfg_value, monkeypatch):
    """``use_fused_ln`` returns what ``_use_fused_ln`` returns, at a width
    the kernels take (128) and one they do not (96), decoding or not."""
    if env is None:
        monkeypatch.delenv("VIT_TPU_FUSED_LN", raising=False)
    else:
        monkeypatch.setenv("VIT_TPU_FUSED_LN", env)
    for width in (128, 96):
        cfg_j, cfg_t = _gate_configs(width, cfg_value)
        for decoding in (False, True):
            want = _use_fused_ln(cfg_j, 0 if decoding else None)
            assert use_fused_ln(cfg_t, decoding) == want, (width, decoding)


@pytest.mark.parametrize("cfg_value", [None, True, False])
@pytest.mark.parametrize("env", [None, "0", "1"])
def test_fused_fc_gate_matches_jax(env, cfg_value, monkeypatch):
    if env is None:
        monkeypatch.delenv("VIT_TPU_FUSED_FC", raising=False)
    else:
        monkeypatch.setenv("VIT_TPU_FUSED_FC", env)
    for width in (128, 96):
        cfg_j, cfg_t = _gate_configs(width, cfg_value)
        assert use_fused_fc(cfg_t) == _use_fused_fc(cfg_j), width


@pytest.mark.parametrize("fc", ["0", "1"])
@pytest.mark.parametrize("ln", ["1", "qkv", "mlp"])
def test_transformer_matches_jax_fused(ln, fc, monkeypatch):
    """The tiny transformer (2 layers, width 128) in fp32 with the same
    switches on both sides: the output and every parameter's gradient, and
    the input's, against the JAX transformer; the fused kernels' plain
    versions ran as often as the sites ask."""
    monkeypatch.setenv("VIT_TPU_FUSED_LN", ln)
    monkeypatch.setenv("VIT_TPU_FUSED_FC", fc)
    kw = dict(**TINY, block_size=24)
    cfg_j = jax_config.TransformerConfig(**kw, dtype=jnp.float32)
    cfg_t = TransformerConfig(**kw, dtype=torch.float32)
    x, g = _rng_arrays(7, (2, 24, 128), (2, 24, 128))
    net_j = JaxTransformer(cfg_j)
    params = net_j.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    y_j, vjp = jax.vjp(lambda p, v: net_j.apply({"params": p}, v), params,
                       jnp.asarray(x))
    dp_j, dx_j = vjp(jnp.asarray(g))

    model = Transformer(cfg_t, device="meta")
    model.load_state_dict(_from_flax(jax.tree.map(np.asarray, params),
                                     model.state_dict()), assign=True)
    calls = count_plain_calls(monkeypatch)
    tx = torch.from_numpy(x).requires_grad_()
    y = model(tx)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(y, [tx, *model.parameters()],
                                torch.from_numpy(g))
    _assert_close(y, y_j, "float32", MODEL_TOL)
    _assert_close(grads[0], dx_j, "float32", MODEL_TOL)
    ref = _from_flax(jax.tree.map(np.asarray, dp_j), model.state_dict())
    assert sorted(ref) == sorted(names)
    for name, grad in zip(names, grads[1:]):
        _assert_close(grad, ref[name], "float32", MODEL_TOL)

    sites = {"1": 2, "qkv": 1, "mlp": 1}[ln] * cfg_t.n_layers
    mlp_fused = ln in ("1", "mlp")
    want = dict(ln_matmul_fwd=sites, ln_bwd=sites,
                ln_matmul_dgelu=cfg_t.n_layers if mlp_fused else 0,
                fc_grad=0 if fc == "0"
                else cfg_t.n_layers * (1 if mlp_fused else 2))
    assert calls == want
