"""Port parity for the gradients of the transformer ops: the GELU's flat
backward, and packed attention's forward statistics (K1) and backward (K2)
through their plain versions, each against ``jax.vjp`` of the JAX package's
function on the same numpy inputs. The Pallas kernels run in interpret mode
on the CPU, as the JAX package's own tests run them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.kernels.attention import flash_attention_packed as jax_packed
from vit_tpu.ops.gelu import gelu as jax_gelu
from vit_tpu_torch.kernels import attention as k_attn
from vit_tpu_torch.kernels import convnext_block as k_cnx
from vit_tpu_torch.ops.gelu import gelu

# fp32 on both sides. The two packages' fp32 tanh differ by a few ulps, and
# the flat derivative's 0.5·x·(1 − t²) term scales that by up to |x| ≈ 10;
# attention's gradients sum S more products than the forward.
GELU_GRAD_TOL = 1e-5
ATTN_GRAD_TOL = 2e-5
STATS_REL_TOL = 1e-5


@pytest.mark.parametrize("impl", ["tanh_erf", "erf", "tanh"])
def test_gelu_backward_matches_jax(impl):
    # N(0, 3) reaches past the tanh_erf clamp at |x/√2| = 4
    rng = np.random.default_rng(10)
    x = rng.normal(0.0, 3.0, 4096).astype(np.float32)
    x[:4] = [-9.0, -6.0, 6.0, 9.0]   # well past the clamp: gradient 0 or 1
    g = rng.normal(size=4096).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax_gelu(v, impl), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    (out,) = torch.autograd.grad(gelu(tx, impl), tx, torch.from_numpy(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=GELU_GRAD_TOL, rtol=GELU_GRAD_TOL)
    np.testing.assert_allclose(out.numpy()[:4] / g[:4], [0.0, 0.0, 1.0, 1.0],
                               atol=GELU_GRAD_TOL)


def test_gelu_backward_keeps_the_input_dtype():
    x = torch.randn(64, dtype=torch.bfloat16, requires_grad=True)
    y = gelu(x)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert y.dtype == dx.dtype == torch.bfloat16


def _inputs(s, seed, b=2, n_heads=2):
    rng = np.random.default_rng(seed)
    width = 64 * n_heads
    qkv = rng.normal(size=(b, s, 3 * width)).astype(np.float32)
    bias = (0.3 * rng.normal(size=(3 * width,))).astype(np.float32)
    g = rng.normal(size=(b, s, width)).astype(np.float32)
    return qkv, bias, g


# a multiple of 8 and not, causal and not; ViT-B/16 @224's S 197 and
# TiTok-B's S 320, the shapes at which K1/K2 are held against these plain
# versions on the card
@pytest.mark.parametrize("s, causal", [(24, False), (24, True), (21, False),
                                       (21, True), (197, False), (320, False)])
def test_packed_attention_backward_matches_jax(s, causal):
    n_heads = 2
    qkv, bias, g = _inputs(s, seed=s + 7 * causal)
    out_j, vjp = jax.vjp(
        lambda q, b: jax_packed(q, n_heads, causal=causal, qkv_bias=b),
        jnp.asarray(qkv), jnp.asarray(bias))
    dqkv_j, dbias_j = vjp(jnp.asarray(g))

    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    out = k_attn.flash_attention_packed(tq, n_heads, causal=causal,
                                        qkv_bias=tb)
    dqkv, dbias = torch.autograd.grad(out, (tq, tb), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(dqkv_j),
                               atol=ATTN_GRAD_TOL, rtol=0)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(dbias_j),
                               atol=ATTN_GRAD_TOL * s, rtol=0)
    # the backward ran K2's plain version, on the saved K1 statistics
    assert k_attn.launches == 0 and k_attn.bwd_launches == 0


@pytest.mark.parametrize("causal", [False, True])
def test_forward_stats_match_a_direct_computation(causal):
    """m = the row max of q·kᵀ/8 (masked), l = Σ exp(s − m), against float64
    numpy on the same biased inputs."""
    s, n_heads = 21, 2
    qkv, bias, _ = _inputs(s, seed=3)
    out, m, l = k_attn.attention_packed_fwd(
        torch.from_numpy(qkv), torch.from_numpy(bias), n_heads, causal,
        emit_stats=True)
    x = (qkv + bias).astype(np.float64).reshape(2, s, 3, n_heads, 64)
    q, k = x[:, :, 0].transpose(0, 2, 1, 3), x[:, :, 1].transpose(0, 2, 1, 3)
    sc = q @ k.transpose(0, 1, 3, 2) / 8.0
    if causal:
        sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    m_ref = sc.max(-1)
    l_ref = np.exp(sc - m_ref[..., None]).sum(-1)
    assert m.shape == l.shape == (2, n_heads, s)
    assert m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), m_ref, rtol=STATS_REL_TOL,
                               atol=STATS_REL_TOL)
    np.testing.assert_allclose(l.numpy(), l_ref, rtol=STATS_REL_TOL)
    # the statistics do not change the output
    plain = k_attn.attention_packed_fwd(torch.from_numpy(qkv),
                                        torch.from_numpy(bias), n_heads,
                                        causal)
    assert torch.equal(out, plain)


def test_inference_skips_the_statistics():
    """Without a gradient to track, attention runs K1 alone: no autograd
    graph, no saved statistics."""
    qkv = torch.randn(1, 8, 384, requires_grad=True)
    with torch.no_grad():
        out = k_attn.flash_attention_packed(qkv, 2)
    assert out.grad_fn is None
    out = k_attn.flash_attention_packed(qkv, 2)
    assert type(out.grad_fn).__name__ == "PackedAttentionBackward"


def test_new_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor runs a plain version; a meta tensor stands in for
    a device here."""
    meta = dict(device="meta")
    qkv = torch.empty(2, 24, 384, **meta)
    stats = torch.empty(2, 2, 24, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        k_attn.attention_packed_bwd(qkv, torch.empty(384, **meta),
                                    torch.empty(2, 24, 128, **meta), stats,
                                    stats, 2, False)
    h = torch.empty(40, 16, **meta)
    params = (torch.empty(16, **meta), torch.empty(16, **meta),
              torch.empty(64, 16, **meta), torch.empty(64, **meta),
              torch.empty(16, 64, **meta), torch.empty(16, **meta),
              torch.empty(16, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        k_cnx.convnext_tail_fwd(h, h, *params)
    with pytest.raises(ValueError, match="unsupported device"):
        k_cnx.convnext_tail_bwd(h, h, *params[:5], params[6])
    assert k_cnx.launches == 0 and k_cnx.bwd_launches == 0
