"""Port parity for the ops and the two kernels' plain versions: GELU, packed
attention (K1) and the nearest-code lookup (K5), each against the JAX
package's function on the same numpy inputs. The Pallas kernels run in
interpret mode on the CPU, as the JAX package's own tests run them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.kernels.attention import flash_attention_packed as jax_packed
from vit_tpu.kernels.vq import nearest_code as jax_nearest_code
from vit_tpu.kernels.vq import nearest_code_xla
from vit_tpu.ops.attention import attention_xla
from vit_tpu.ops.attention import fused_qkv_attention as jax_fused_qkv
from vit_tpu.ops.gelu import gelu as jax_gelu
from vit_tpu_torch.kernels import attention as k_attn
from vit_tpu_torch.kernels import vq as k_vq
from vit_tpu_torch.ops.attention import attention_ref, fused_qkv_attention
from vit_tpu_torch.ops.gelu import gelu

ATTN_TOL = 1e-5  # fp32 on both sides; only the summation order differs


@pytest.mark.parametrize("impl", ["tanh_erf", "erf", "tanh"])
def test_gelu_matches_jax(impl):
    # N(0, 3) reaches past the tanh_erf clamp at |x/√2| = 4
    x = np.random.default_rng(0).normal(0.0, 3.0, 4096).astype(np.float32)
    out = gelu(torch.from_numpy(x), impl).numpy()
    ref = np.asarray(jax_gelu(jnp.asarray(x), impl))
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_gelu_env_hatch_and_dtype(monkeypatch):
    x = np.random.default_rng(1).normal(0.0, 2.0, 512).astype(np.float32)
    monkeypatch.setenv("VIT_TPU_GELU", "erf")
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    assert gelu(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        gelu(torch.from_numpy(x), "relu")


def _unpack(qkv, n_heads):
    b, s, three_d = qkv.shape
    d = three_d // 3 // n_heads
    return qkv.reshape(b, s, 3, n_heads, d).transpose(2, 0, 3, 1, 4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [20, 24])
def test_packed_attention_matches_jax(s, causal):
    rng = np.random.default_rng(s)
    b, n_heads, width = 2, 2, 128
    qkv = rng.normal(size=(b, s, 3 * width)).astype(np.float32)
    bias = (0.3 * rng.normal(size=(3 * width,))).astype(np.float32)

    pallas = np.asarray(jax_packed(jnp.asarray(qkv), n_heads, causal=causal,
                                   qkv_bias=jnp.asarray(bias)))
    q, k, v = _unpack(jnp.asarray(qkv + bias), n_heads)
    xla = np.asarray(attention_xla(q, k, v, causal=causal)
                     .transpose(0, 2, 1, 3).reshape(b, s, width))
    np.testing.assert_allclose(pallas, xla, atol=ATTN_TOL, rtol=0)

    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    kernel_path = k_attn.flash_attention_packed(tq, n_heads, causal=causal,
                                                qkv_bias=tb).numpy()
    ops_path = fused_qkv_attention(tq, n_heads, causal=causal,
                                   qkv_bias=tb).numpy()
    uq, uk, uv = (tq + tb).reshape(b, s, 3, n_heads, 64).permute(2, 0, 3, 1, 4)
    ref = (attention_ref(uq, uk, uv, causal=causal)
           .transpose(1, 2).reshape(b, s, width).numpy())
    for out in (kernel_path, ops_path, ref):
        np.testing.assert_allclose(out, pallas, atol=ATTN_TOL, rtol=0)
        np.testing.assert_allclose(out, xla, atol=ATTN_TOL, rtol=0)


def test_unpacked_shape_matches_jax_fallback():
    """head_dim 48 is not packed-supported: the CPU runs attention_ref."""
    qkv = np.random.default_rng(3).normal(size=(2, 19, 3 * 96)).astype(
        np.float32)
    bias = np.random.default_rng(4).normal(size=(3 * 96,)).astype(np.float32)
    ref = np.asarray(jax_fused_qkv(jnp.asarray(qkv), 2, causal=True,
                                   impl="xla", qkv_bias=jnp.asarray(bias)))
    out = fused_qkv_attention(torch.from_numpy(qkv), 2, causal=True,
                              qkv_bias=torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATTN_TOL, rtol=0)


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor runs a plain version; anything else launches or
    raises (a meta tensor stands in for a device here)."""
    qkv = torch.empty(2, 24, 384, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k_attn.flash_attention_packed(qkv, 2)
    with pytest.raises(NotImplementedError, match="K6"):
        fused_qkv_attention(torch.empty(2, 19, 288, device="meta"), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        k_vq.nearest_code(torch.empty(5, 12, device="meta"),
                          torch.empty(7, 12, device="meta"))
    # dropout on a device tensor launches the kernel's dropout branch or
    # raises, and without a seed it raises anywhere
    with pytest.raises(ValueError, match="unsupported device"):
        k_attn.flash_attention_packed(
            qkv, 2, dropout_rate=0.1,
            seed=torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="requires a seed"):
        k_attn.flash_attention_packed(torch.zeros(1, 4, 384), 2,
                                      dropout_rate=0.1)
    assert k_attn.launches == 0 and k_vq.launches == 0


@pytest.mark.parametrize("l2", [True, False])
def test_nearest_code_matches_jax(l2):
    rng = np.random.default_rng(5)
    z = rng.normal(size=(50, 12)).astype(np.float32)
    cb = rng.normal(size=(300, 12)).astype(np.float32)
    pallas = np.asarray(jax_nearest_code(jnp.asarray(z), jnp.asarray(cb),
                                         l2_normalize=l2, impl="pallas"))
    xla = np.asarray(nearest_code_xla(jnp.asarray(z), jnp.asarray(cb),
                                      l2_normalize=l2))
    tz, tcb = torch.from_numpy(z), torch.from_numpy(cb)
    ref = k_vq.nearest_code_ref(tz, tcb, l2_normalize=l2)
    out = k_vq.nearest_code(tz.reshape(5, 10, 12), tcb, l2_normalize=l2)
    assert ref.dtype == out.dtype == torch.int32
    assert out.shape == (5, 10)
    np.testing.assert_array_equal(ref.numpy(), pallas)
    np.testing.assert_array_equal(ref.numpy(), xla)
    np.testing.assert_array_equal(out.reshape(-1).numpy(), pallas)


@pytest.mark.parametrize("l2", [True, False])
def test_nearest_code_ties_go_to_lowest_index(l2):
    rng = np.random.default_rng(6)
    cb = rng.normal(size=(16, 12)).astype(np.float32)
    cb[9] = cb[3]
    cb[14] = cb[3]
    z = np.repeat(cb[3:4], 4, axis=0)
    out = k_vq.nearest_code(torch.from_numpy(z), torch.from_numpy(cb),
                            l2_normalize=l2)
    assert out.tolist() == [3] * 4
    pallas = jax_nearest_code(jnp.asarray(z), jnp.asarray(cb),
                              l2_normalize=l2, impl="pallas")
    assert np.asarray(pallas).tolist() == [3] * 4
