"""Port parity for attention at head_dim 32, the MAE-B decoder's heads (16 ×
32): K1/K2's plain versions (what the 32-wide CUDA instantiations are held
to on the card) against the Pallas packed kernel and its VJP in interpret
mode, with the bias and with dropout; the dropout mask bit for bit (the
JAX kernel's stream id (pid_b·bb + bi)·H + h2·hb + j, hb = 128/d heads a
lane block, is the port's b·H + h); K6/K7/K8's plain versions at d 32 and
S > 768; and the routing rule, ``packed_supported``, against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import scaled_err
from vit_tpu.kernels.attention import flash_attention as jax_flash_attention
from vit_tpu.kernels.attention import flash_attention_packed as jax_packed
from vit_tpu.kernels.attention import packed_supported as jax_packed_supported
from vit_tpu_torch.kernels import attention as k_attn

# as tests/test_torch_dropout.py: fp32 on both sides, only the summation
# order differs; bf16 within 2^-6 of the largest magnitude
ATTN_TOL = 1e-5
ATTN_GRAD_TOL = 1e-4
BF16_REL = 2.0 ** -6
N_HEADS, D = 4, 32


def _seed(key: int):
    rng = jax.random.PRNGKey(key)
    seed = jax.random.randint(rng, (1,), 0, 2 ** 31 - 1, jnp.int32)
    return rng, torch.from_numpy(np.array(seed))


def _packed_inputs(s, seed, b=2):
    rng = np.random.default_rng(seed)
    width = D * N_HEADS
    return (rng.normal(size=(b, s, 3 * width)).astype(np.float32),
            (0.3 * rng.normal(size=(3 * width,))).astype(np.float32),
            rng.normal(size=(b, s, width)).astype(np.float32))


@pytest.mark.parametrize("s, rate, dtype", [
    (65, 0.0, "float32"),      # MAE-B's encoder S at a 32-wide head
    (257, 0.0, "float32"),     # the decoder's S
    (257, 0.15, "float32"),
    (65, 0.1, "bfloat16"),
])
def test_packed_hd32_matches_jax(s, rate, dtype):
    """Output, dqkv and the bias gradient of K1/K2's plain versions against
    ``flash_attention_packed`` and its VJP, biased, with and without
    dropout."""
    qkv, bias, g = _packed_inputs(s, 31 + s)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng, seed = _seed(s + 3)
    kw = dict(dropout_rate=rate, dropout_rng=rng) if rate else {}
    out_j, vjp = jax.vjp(lambda q, b: jax_packed(q, N_HEADS, qkv_bias=b, **kw),
                         jnp.asarray(qkv, jdt), jnp.asarray(bias, jdt))
    dqkv_j, dbias_j = vjp(jnp.asarray(g, jdt))
    tq = torch.from_numpy(qkv).to(tdt).requires_grad_()
    tb = torch.from_numpy(bias).to(tdt).requires_grad_()
    out = k_attn.flash_attention_packed(
        tq, N_HEADS, dropout_rate=rate, seed=seed if rate else None,
        qkv_bias=tb)
    dqkv, dbias = torch.autograd.grad(out, (tq, tb),
                                      torch.from_numpy(g).to(tdt))
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
    assert k_attn.launches == k_attn.bwd_launches == 0


@pytest.mark.parametrize("s", [65, 257])
def test_packed_hd32_dropout_mask_bit_for_bit(s):
    """The mask probe: q = k = 0 (p = 1, l = S) and v one-hot over a block
    of 32 keys, so each output element is D[i, j]/S of one key j, computed
    exactly on both sides: equal bit for bit, for every block of keys, and
    equal to ``dropout_mask`` of stream b·H + h."""
    b, rate = 2, 0.15
    rng, seed = _seed(7 * s)
    width = D * N_HEADS
    blocks = -(-s // D)
    for kb in range(blocks):
        qkv = np.zeros((b, s, 3 * width), np.float32)
        keys = np.arange(kb * D, min(s, (kb + 1) * D))
        for h in range(N_HEADS):
            qkv[:, keys, 2 * width + h * D + keys - kb * D] = 1.0
        out_j = np.asarray(jax_packed(jnp.asarray(qkv), N_HEADS,
                                      dropout_rate=rate, dropout_rng=rng))
        out = k_attn.flash_attention_packed(torch.from_numpy(qkv), N_HEADS,
                                            dropout_rate=rate, seed=seed)
        np.testing.assert_array_equal(out.numpy(), out_j)
        mask = k_attn._head_mask(k_attn.seed_vec(seed), b, N_HEADS, s, rate)
        heads = out.reshape(b, s, N_HEADS, D).permute(0, 2, 1, 3)
        want = mask[..., keys] / s
        np.testing.assert_array_equal(heads[..., :len(keys)].numpy(),
                                      want.numpy())


def test_unpacked_hd32_matches_jax():
    """K6's and K8's plain versions at d 32, S 800 (> 768: the tiled
    backward), causal with dropout, against ``flash_attention`` and its
    VJP."""
    s, rate = 800, 0.1
    rng_np = np.random.default_rng(5)
    q, k, v, g = (rng_np.normal(size=(1, 2, s, D)).astype(np.float32)
                  for _ in range(4))
    rng, seed = _seed(11)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, causal=True,
                                            dropout_rate=rate,
                                            dropout_rng=rng),
        *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = k_attn.flash_attention(tq, tk, tv, causal=True, dropout_rate=rate,
                                 seed=seed)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=ATTN_TOL, rtol=0)
    for got, want in zip(grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATTN_GRAD_TOL, rtol=0)


@pytest.mark.parametrize("n_heads", [1, 2, 3, 4, 8, 12, 16, 24])
@pytest.mark.parametrize("width", [64, 96, 128, 192, 256, 384, 512, 768,
                                   1024])
def test_packed_supported_matches_jax(n_heads, width):
    for s in (1, 65, 257, 768, 769, 1024):
        assert k_attn.packed_supported(n_heads, width, s) == \
            jax_packed_supported(n_heads, width, s), (n_heads, width, s)


@pytest.mark.parametrize("d", [8, 16, 128])
def test_cuda_refuses_widths_without_an_instantiation(d):
    """A head width the JAX kernels take but the CUDA kernels are not built
    for raises, naming its ROADMAP item; 32 and 64 pass."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A #11"):
        k_attn.check_head_dim(d, "K1")
    for ok in k_attn.HEAD_DIMS:
        k_attn.check_head_dim(ok, "K1")
    assert k_attn.HEAD_DIMS == (32, 64)
