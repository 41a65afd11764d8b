"""Port parity for attention dropout: the counter-hash keep mask bit for bit
against the JAX package's ``_dropout_mask``, and the plain versions of K1/K2
(packed) and K6, K7/K8 (unpacked) with dropout against the Pallas kernels
and their ``jax.vjp`` in interpret mode, each side given the same int32
seed. The plain versions are what the CUDA kernels are held to on the
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import scaled_err
from vit_tpu.kernels.attention import _dropout_mask
from vit_tpu.kernels.attention import flash_attention as jax_flash_attention
from vit_tpu.kernels.attention import flash_attention_packed as jax_packed
from vit_tpu_torch.kernels import attention as k_attn

# fp32 on both sides with the same mask: only summation order differs. The
# backward sums S more products per element than the forward.
ATTN_TOL = 1e-5
ATTN_GRAD_TOL = 1e-4
# bf16 operands: both sides round p, dO/l and ds to bf16 at the same points,
# but an fp32 value one ulp apart rounds one bf16 ulp (2^-8 relative) the
# other way and travels through the next product: outputs and gradients
# within 2^-6 of their largest magnitude.
BF16_REL = 2.0 ** -6


def _seed(key: int):
    """The seed as the JAX package draws it from a dropout key, and the same
    int32 for the port."""
    rng = jax.random.PRNGKey(key)
    seed = jax.random.randint(rng, (1,), 0, 2 ** 31 - 1, jnp.int32)
    return rng, torch.from_numpy(np.array(seed))


@pytest.mark.parametrize("rate", [0.1, 0.15, 0.5])
@pytest.mark.parametrize("seed, hid, row0, stride, shape", [
    (2 ** 31 - 2, 5, 0, 40, (40, 40)),             # the largest seed
    (123456789, 2 ** 32 - 3, 512, 777, (64, 48)),  # a wrapping stream id
    (7, 2 ** 31 + 11, 300, 1024, (24, 96)),        # stride ≠ width, row0 > 0
])
def test_dropout_mask_matches_jax(rate, seed, hid, row0, stride, shape):
    ref = _dropout_mask(jnp.array([seed, 0], jnp.int32), jnp.uint32(hid),
                        shape, rate, row0=row0, stride=stride)
    out = k_attn.dropout_mask(torch.tensor([seed, 0], dtype=torch.int32), hid,
                              *shape, row0, stride, rate)
    assert out.dtype == torch.float32 and out.shape == shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # the threshold and scale are the host's, as the JAX package forms them
    threshold, scale = k_attn.dropout_consts(rate)
    assert threshold == int(rate * 0xFFFFFFFF)
    assert np.float32(scale) == np.float32(1.0 / (1.0 - rate))
    assert set(np.unique(out.numpy())) <= {0.0, np.float32(scale)}


def test_dropout_mask_streams_by_batch_and_head():
    """The plain versions' (B, H) streams are hid = b·H + h + offset."""
    seed = torch.tensor([99, 3], dtype=torch.int32)
    masks = k_attn._head_mask(seed, 2, 3, 16, 0.3)
    for b in range(2):
        for h in range(3):
            want = k_attn.dropout_mask(seed, b * 3 + h + 3, 16, 16, 0, 16, 0.3)
            assert torch.equal(masks[b, h], want)


def _packed_inputs(s, seed, dtype, b=2, n_heads=2):
    rng = np.random.default_rng(seed)
    width = 64 * n_heads
    qkv = rng.normal(size=(b, s, 3 * width)).astype(np.float32)
    bias = (0.3 * rng.normal(size=(3 * width,))).astype(np.float32)
    g = rng.normal(size=(b, s, width)).astype(np.float32)
    return [jnp.asarray(x, dtype) for x in (qkv, bias, g)]


@pytest.mark.parametrize("s, causal, dtype, rate", [
    (257, False, "float32", 0.15),   # ViT-L @256's S, not a multiple of 8
    (40, True, "float32", 0.1),
    (40, False, "bfloat16", 0.15),
])
def test_packed_dropout_matches_jax(s, causal, dtype, rate):
    """K1/K2's plain versions with dropout against the Pallas packed kernel
    and its VJP: output, dqkv and the bias gradient."""
    n_heads = 2
    qkv, bias, g = _packed_inputs(s, 17 + s + causal, getattr(jnp, dtype))
    rng, seed = _seed(s)
    out_j, vjp = jax.vjp(
        lambda q, b: jax_packed(q, n_heads, causal=causal, dropout_rate=rate,
                                dropout_rng=rng, qkv_bias=b), qkv, bias)
    dqkv_j, dbias_j = vjp(g)

    tdt = getattr(torch, dtype)
    tq = torch.from_numpy(np.array(qkv, np.float32)).to(tdt).requires_grad_()
    tb = torch.from_numpy(np.array(bias, np.float32)).to(tdt).requires_grad_()
    tg = torch.from_numpy(np.array(g, np.float32)).to(tdt)
    out = k_attn.flash_attention_packed(tq, n_heads, causal=causal,
                                        dropout_rate=rate, seed=seed,
                                        qkv_bias=tb)
    dqkv, dbias = torch.autograd.grad(out, (tq, tb), tg)
    pairs = [(out.detach(), out_j), (dqkv, dqkv_j), (dbias, dbias_j)]
    if dtype == "float32":
        for (got, want), tol in zip(pairs, (ATTN_TOL, ATTN_GRAD_TOL,
                                            ATTN_GRAD_TOL * s)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=tol, rtol=0)
    else:
        for got, want in pairs:
            assert scaled_err(got.float().numpy(),
                              np.asarray(want, np.float32)) <= BF16_REL
    # dropout changed the output: the same call without it differs
    plain = k_attn.flash_attention_packed(tq.detach(), n_heads, causal=causal,
                                          qkv_bias=tb.detach())
    assert not torch.allclose(plain, out.detach(), atol=1e-3)
    assert k_attn.launches == k_attn.bwd_launches == 0


def _qkv(s, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 2, s, 64)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("s", [513, 800])   # K7 (S ≤ 768) and K8 (S > 768)
def test_unpacked_dropout_matches_jax(s):
    """K6's and K7/K8's plain versions with dropout, causal, against the
    Pallas ``_fa_kernel`` (two q blocks of 512: row0 > 0, stride the logical
    S) and its untiled (513) or tiled (800) backward."""
    rate = 0.1
    q, k, v, g = _qkv(s, seed=40 + s)
    rng, seed = _seed(s + 1)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, causal=True,
                                            dropout_rate=rate,
                                            dropout_rng=rng),
        *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = k_attn.flash_attention(tq, tk, tv, causal=True, dropout_rate=rate,
                                 seed=seed)
    assert type(out.grad_fn).__name__ == "UnpackedAttentionBackward"
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=ATTN_TOL, rtol=0)
    for name, got, want in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATTN_GRAD_TOL, rtol=0, err_msg=name)
    assert k_attn.unpacked_launches == k_attn.unpacked_bwd_launches == 0


def test_dropout_needs_a_seed_and_a_rate_below_one():
    qkv = torch.randn(1, 8, 384)
    q = torch.randn(1, 2, 8, 64)
    with pytest.raises(ValueError, match="requires a seed"):
        k_attn.flash_attention_packed(qkv, 2, dropout_rate=0.1)
    with pytest.raises(ValueError, match="requires a seed"):
        k_attn.flash_attention(q, q, q, dropout_rate=0.1)
    seed = torch.tensor([5], dtype=torch.int32)
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            k_attn.flash_attention(q, q, q, dropout_rate=rate, seed=seed)
    with pytest.raises(ValueError, match="one int32"):
        k_attn.flash_attention(q, q, q, dropout_rate=0.1,
                               seed=torch.tensor([1, 2], dtype=torch.int32))
    # rate 0 ignores the seed: the same bits as no dropout
    assert torch.equal(k_attn.flash_attention(q, q, q, seed=seed),
                       k_attn.flash_attention(q, q, q))


def test_dropout_wrappers_never_fall_back_off_the_cpu():
    """A device tensor with dropout launches the kernel or raises, here
    (no card) always raises; a meta tensor stands in for a device."""
    meta = dict(device="meta")
    seed = torch.tensor([1, 0], dtype=torch.int32)
    drop = dict(dropout_rate=0.15, seed=seed)
    qkv = torch.empty(2, 24, 384, **meta)
    stats = torch.empty(2, 2, 24, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        k_attn.attention_packed_fwd(qkv, torch.empty(384, **meta), 2, False,
                                    **drop)
    with pytest.raises(ValueError, match="unsupported device"):
        k_attn.attention_packed_bwd(qkv, torch.empty(384, **meta),
                                    torch.empty(2, 24, 128, **meta), stats,
                                    stats, 2, False, **drop)
    t = torch.empty(2, 2, 24, 64, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        k_attn.attention_fwd(t, t, t, True, **drop)
    with pytest.raises(ValueError, match="unsupported device"):
        k_attn.attention_bwd(t, t, t, t, stats, stats, True, **drop)
    with pytest.raises(ValueError, match="unsupported device"):
        k_attn.flash_attention_packed(qkv, 2, dropout_rate=0.1,
                                      seed=seed[:1].to("meta"))
    assert k_attn.launches == k_attn.bwd_launches == 0
    assert k_attn.unpacked_launches == k_attn.unpacked_bwd_launches == 0
    assert k_attn.dropout_launches == k_attn.unpacked_dropout_launches == 0
