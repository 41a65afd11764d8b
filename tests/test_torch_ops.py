"""Port parity for the ops and the two kernels' plain versions: GELU, packed
attention (K1) and the nearest-code lookup (K5), each against the JAX
package's function on the same numpy inputs. The Pallas kernels run in
interpret mode on the CPU, as the JAX package's own tests run them. K5's
host plan (row blocks, code slices) is checked at the paths' shapes, and
an emulation of its slice-and-merge (first best within a warp's quarter,
the warps by max score then lowest index, the slices through one 64-bit
key a row) holds the JAX package's kernel and XLA oracle with equal codes
on both sides of slice boundaries."""

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


@pytest.mark.parametrize("n, c, row_blocks, splits", [
    (2048, 2048, 16, 32), (16384, 2048, 128, 5), (32768, 1024, 256, 3),
    (2053, 2048, 17, 32), (50, 300, 1, 4), (33, 64, 1, 1)])
def test_nearest_code_plan_covers_every_code_once(n, c, row_blocks, splits):
    """K5's host plan (``kernels/vq.py:plan``) on 132 SMs at the paths'
    shapes (serving bs 8 and the train step's N against 2048 codes, the
    VideoGPT step's 32768 against 1024) and small ones: 4 rows a lane (128
    a block), the codes cut into slices so that about four blocks fill an
    SM, every code in exactly one slice, none empty, each within the
    shared-memory budget and at least MIN_SLICE codes unless it is all C."""
    p = k_vq.plan(n, c, 12, 132)
    assert p["rows_per_lane"] == k_vq.rows_per_lane(12) == 4
    assert (p["row_blocks"], p["splits"]) == (row_blocks, splits)
    assert p["blocks"] == row_blocks * splits
    assert (row_blocks - 1) * p["rows_per_block"] < n <= row_blocks * p["rows_per_block"]
    slices = [range(s * p["slice"], min(c, (s + 1) * p["slice"]))
              for s in range(p["splits"])]
    assert all(len(r) > 0 for r in slices)
    assert [i for r in slices for i in r] == list(range(c))
    assert p["slice"] * 13 * 4 <= k_vq.MAX_SLICE_BYTES
    assert p["slice"] >= min(c, k_vq.MIN_SLICE)


def _pack(score: np.ndarray, index: np.ndarray) -> np.ndarray:
    """K5's 64-bit key (``csrc/vq_nearest.cu:pack``): the score's bits made
    order-preserving (−0.0 as +0.0) above the index's complement."""
    u = (score.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    ord_ = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return (ord_.astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - index.astype(np.uint64))


def _k5_sliced(z, cb, l2, grid, warps=4):
    """K5's order in numpy fp32: scores z·e (− ‖e‖²/2), the codes cut into
    the plan's slices and each slice into ``warps`` quarters; the first
    best of a quarter (strict >), the quarters merged by max score then
    lowest index, the slices through the max of their 64-bit keys."""
    z, e = z.astype(np.float32), cb.astype(np.float32)
    ee = (e * e).sum(-1, dtype=np.float32)
    if l2:
        z = z / np.sqrt((z * z).sum(-1, keepdims=True) + np.float32(1e-24))
        e = e / np.sqrt(ee[:, None] + np.float32(1e-24))
    scores = np.zeros((z.shape[0], e.shape[0]), np.float32)
    for k in range(z.shape[1]):
        scores = scores + z[:, k:k + 1] * e[None, :, k]
    if not l2:
        scores = scores - np.float32(0.5) * ee[None]
    key = np.zeros(z.shape[0], np.uint64)
    rows = np.arange(z.shape[0])
    for lo in range(0, e.shape[0], grid["slice"]):
        n = min(e.shape[0], lo + grid["slice"]) - lo
        q = -(-n // warps)
        best = np.full(z.shape[0], -np.inf, np.float32)
        bi = np.zeros(z.shape[0], np.int64)
        for w in range(warps):
            j0, j1 = lo + w * q, lo + min(n, (w + 1) * q)
            if j0 >= j1:
                continue
            j = j0 + scores[:, j0:j1].argmax(-1)   # the first best
            v = scores[rows, j]
            take = (v > best) | ((v == best) & (j < bi))
            best, bi = np.where(take, v, best), np.where(take, j, bi)
        key = np.maximum(key, _pack(best, bi))
    return (np.uint64(0xFFFFFFFF) - (key & np.uint64(0xFFFFFFFF))).astype(
        np.int32)


def test_nearest_code_key_orders_score_then_lowest_index():
    """The key's max is the best score and, among equal scores (−0.0 and
    +0.0 too), the lowest index."""
    cases = [([1.0, 1.0], [7, 2], 2), ([-0.0, 0.0], [5, 3], 3),
             ([0.0, -0.0], [3, 5], 3), ([-1.0, -2.0], [9, 1], 9),
             ([-1e-30, 1e-30], [0, 4], 4), ([3.5, -np.inf], [6, 0], 6)]
    for scores, idx, want in cases:
        keys = _pack(np.array(scores, np.float32), np.array(idx))
        got = 0xFFFFFFFF - int(keys.max() & np.uint64(0xFFFFFFFF))
        assert got == want, (scores, idx)


@pytest.mark.parametrize("l2", [True, False])
def test_nearest_code_slices_merge_to_the_lowest_index(l2):
    """K5's slice-and-merge against the JAX package's kernel (interpret
    mode) and ``nearest_code_xla`` on test_nearest_code_matches_jax's
    inputs with equal codes on both sides of a slice boundary (74 | 75),
    at the next one (150) and inside a warp's quarter (80): the rows
    equal to them take code 74 in all three."""
    rng = np.random.default_rng(5)
    z = rng.normal(size=(50, 12)).astype(np.float32)
    cb = rng.normal(size=(300, 12)).astype(np.float32)
    grid = k_vq.plan(50, 300, 12, 132)
    assert grid["slice"] == 75 and grid["splits"] == 4
    for j in (75, 80, 150):
        cb[j] = cb[74]
    z[:6] = cb[74] * (2.0 if l2 else 1.0)
    ours = _k5_sliced(z, cb, l2, grid)
    pallas = np.asarray(jax_nearest_code(jnp.asarray(z), jnp.asarray(cb),
                                         l2_normalize=l2, impl="pallas"))
    xla = np.asarray(nearest_code_xla(jnp.asarray(z), jnp.asarray(cb),
                                      l2_normalize=l2))
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, xla)
    assert ours[:6].tolist() == [74] * 6
