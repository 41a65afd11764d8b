"""The port's int8 serving path on the CPU against the JAX package's
(``vit_tpu/core/quant.py:77-158`` and the int8 sites of
``vit_tpu/core/transformer.py``): ``quantize_params``, ``QuantLinear`` against
``QuantDense``, the int8 TiTok, ViT classifier and VideoGPT (prefill and
decode step) on bridged weights at fp32 compute, and ``int8_matmul``'s
row pad for ``torch._int_mm`` on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (TITOK, codes, images, jax_params, tiny_preset,
                                videogpt_configs, videogpt_params)
from vit_tpu.core.quant import QuantDense
from vit_tpu.core.quant import quantize_params as jax_quantize_params
from vit_tpu.models.titok import TiTok as JaxTiTok
from vit_tpu.models.titok import TiTokConfig as JaxTiTokConfig
from vit_tpu_torch.bridge import (flatten, flax_tree,
                                  module_state_dict_from_flax)
from vit_tpu_torch.core import quant
from vit_tpu_torch.models.titok import TiTok, TiTokConfig

REL = 1e-3   # int8 port vs int8 JAX at fp32 compute, relative to max |ref|
VIT = dict(image_size=32, in_channels=3, patch_size=8, transformer="tiny",
           extra_tokens=1)
N_CLASSES = 10


def rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def mean_rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).mean() / np.abs(ref).mean())


def jax_int8_tree(net_q, params, *init_args):
    """JAX ``quantize_params`` of ``params`` into ``net_q``'s tree, numpy."""
    target = jax.eval_shape(net_q.init, jax.random.PRNGKey(0),
                            *init_args)["params"]
    tree = jax_quantize_params(target, jax.tree.map(jnp.asarray, params))
    return jax.tree.map(np.asarray, tree)


def port_int8(model_q, tree):
    """The port's int8 ``model_q`` filled from a JAX int8 tree."""
    model_q.load_state_dict(module_state_dict_from_flax(tree, model_q))
    return model_q.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def titok():
    """The tiny fp32 TiTok's JAX init, its JAX int8 tree and both int8
    models."""
    with tiny_preset():
        cfg_j = JaxTiTokConfig(**TITOK, dtype=jnp.float32, quant="int8")
        cfg_t = TiTokConfig(**TITOK, dtype=torch.float32, quant="int8")
        fp = jax_params(JaxTiTokConfig(**TITOK, dtype=jnp.float32))
        net_j = JaxTiTok(cfg_j)
        tree = jax_int8_tree(net_j, fp, jnp.zeros((1, 32, 32, 3)))
        model = port_int8(TiTok(cfg_t), tree)
    return fp, tree, net_j, model


def near_half(w: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Where |w / scale| lies within 1e-5 of a half-integer: the rounding
    of the quantized level can go either way there."""
    r = np.abs(w.astype(np.float64) / scale.astype(np.float64))
    return np.abs(r - np.floor(r) - 0.5) < 1e-5


def test_quantize_params_matches_jax(titok):
    """The port's ``quantize_params`` on the JAX fp tree, into the target
    the port's int8 TiTok gives, against the JAX one: the same keys, dtypes
    and shapes; ``kernel_q`` bit-equal except near half-integer levels
    (counted); ``scale`` within one ulp; every other leaf copied."""
    fp, want, _, model = titok
    with tiny_preset():
        target = flax_tree(TiTok(model.config, device="meta").state_dict())
    got = flatten(quant.quantize_params(target, fp))
    want = flatten(want)
    assert got.keys() == want.keys()
    sites = [k.removesuffix("/kernel_q") for k in want if k.endswith("kernel_q")]
    assert len(sites) == 2 * 2 * 3   # 2 ViTs × 2 layers × (qkv, fc1, fc2)
    assert not any(k.endswith("qkv/kernel") for k in got)
    flat_fp = flatten(fp)
    near, total = 0, 0
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k.endswith("kernel_q"):
            site = k.removesuffix("/kernel_q")
            tie = near_half(flat_fp[site + "/kernel"], want[site + "/scale"])
            near, total = near + int(tie.sum()), total + tie.size
            np.testing.assert_array_equal(got[k][~tie], want[k][~tie],
                                          err_msg=k)
            assert np.abs(got[k][tie].astype(int)
                          - want[k][tie].astype(int)).max(initial=0) <= 1
        elif k.removesuffix("/scale") in sites:
            np.testing.assert_array_max_ulp(got[k], want[k], maxulp=1)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert near <= 1e-4 * total   # 2e-5 of uniform levels lie that near


def test_quantize_params_ln_scale_and_shape_refusal():
    """An affine LayerNorm's ``scale`` (no ``kernel_q`` beside it) copies
    through, as in JAX; a leaf of another shape and a site without a
    ``kernel`` raise in both packages."""
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(16, 24)).astype(np.float32)
    fp = {"ln1": {"scale": rng.normal(size=16).astype(np.float32),
                  "bias": rng.normal(size=16).astype(np.float32)},
          "fc1": {"kernel": kernel,
                  "bias": rng.normal(size=24).astype(np.float32)}}
    target = {"ln1": {"scale": np.zeros(16), "bias": np.zeros(16)},
              "fc1": {"kernel_q": np.zeros((16, 24), np.int8),
                      "scale": np.zeros(24), "bias": np.zeros(24)}}
    got = quant.quantize_params(target, fp)
    want = jax_quantize_params(target, jax.tree.map(jnp.asarray, fp))
    np.testing.assert_array_equal(got["ln1"]["scale"].numpy(), fp["ln1"]["scale"])
    np.testing.assert_array_equal(got["ln1"]["scale"].numpy(),
                                  np.asarray(want["ln1"]["scale"]))
    np.testing.assert_array_equal(got["fc1"]["kernel_q"].numpy(),
                                  np.asarray(want["fc1"]["kernel_q"]))
    assert got["fc1"]["kernel_q"].dtype == torch.int8
    bad = {**target, "ln1": {"scale": np.zeros(8), "bias": np.zeros(16)}}
    for fn in (quant.quantize_params, jax_quantize_params):
        with pytest.raises(ValueError, match="shape mismatch"):
            fn(bad, fp)
        with pytest.raises(ValueError, match="expects a source 'kernel'"):
            fn(target, {**fp, "fc1": {"bias": fp["fc1"]["bias"]}})
    wide = {**target, "fc1": {**target["fc1"],
                              "kernel_q": np.zeros((16, 32), np.int8)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        quant.quantize_params(wide, fp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_linear_matches_quant_dense(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    kq, scale = quant.quantize_kernel(torch.from_numpy(
        rng.normal(size=(64, 48)).astype(np.float32)))
    bias = rng.normal(size=48).astype(np.float32)
    dense = QuantDense(48, 64, dtype=getattr(jnp, dtype))
    want = dense.apply({"params": {"kernel_q": jnp.asarray(kq.numpy()),
                                   "scale": jnp.asarray(scale.numpy()),
                                   "bias": jnp.asarray(bias)}},
                       jnp.asarray(x, getattr(jnp, dtype)))
    layer = quant.QuantLinear(64, 48, getattr(torch, dtype))
    layer.load_state_dict({"kernel_q": kq, "scale": scale,
                           "bias": torch.from_numpy(bias)})
    got = layer(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 5, 48)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert [k for k, _ in layer.named_buffers()] == ["kernel_q", "scale",
                                                     "bias"]
    assert list(layer.parameters()) == []


def test_int8_titok_matches_jax(titok):
    """Encoder latents, codes and decoded images of the int8 TiTok against
    the JAX int8 TiTok on the same tree."""
    _, tree, net_j, model = titok
    p = jax.tree.map(jnp.asarray, tree)
    x = images(3, seed=5)
    lat_j = jax.jit(lambda p, x: net_j.apply(
        {"params": p}, x, method=lambda m, x: m.enc(x)))(p, x)
    idx_j = jax.jit(lambda p, x: net_j.apply({"params": p}, x,
                                             method=net_j.encode))(p, x)
    with torch.no_grad():
        lat = model.enc(torch.from_numpy(x))
        idx = model.encode(torch.from_numpy(x))
    assert rel(lat, lat_j) < REL
    idx_j = np.asarray(idx_j)
    flips = idx.numpy() != idx_j
    if flips.any():   # only near-ties of the two latents' codes
        cb = model.quant.codebook.numpy()
        cb = cb / np.linalg.norm(cb, axis=-1, keepdims=True)
        z = np.asarray(lat_j)[flips]
        z = z / np.linalg.norm(z, axis=-1, keepdims=True)
        gap = np.abs((z * (cb[idx.numpy()[flips]] - cb[idx_j[flips]])).sum(-1))
        assert gap.max() < 10 * rel(lat, lat_j)
    assert flips.mean() < 0.05
    rec_j = jax.jit(lambda p, i: net_j.apply(
        {"params": p}, i, method=net_j.decode_indices))(p, jnp.asarray(idx_j))
    with torch.no_grad():
        rec = model.decode_indices(torch.from_numpy(idx_j))
    assert rec.shape == (3, 32, 32, 3) and rel(rec, rec_j) < REL


def test_int8_classifier_matches_jax():
    from vit_tpu.models.vit import ViTClassifier as JaxViTClassifier
    from vit_tpu.models.vit import ViTConfig as JaxViTConfig
    from vit_tpu_torch.models.vit import ViTClassifier, ViTConfig

    with tiny_preset():
        fp_net = JaxViTClassifier(JaxViTConfig(**VIT, dropout=0.0,
                                               dtype=jnp.float32),
                                  num_classes=N_CLASSES)
        x0 = jnp.zeros((1, 32, 32, 3))
        fp = jax.jit(fp_net.init)(jax.random.PRNGKey(2), x0)["params"]
        net_j = JaxViTClassifier(JaxViTConfig(**VIT, dropout=0.0,
                                              dtype=jnp.float32, quant="int8"),
                                 num_classes=N_CLASSES)
        tree = jax_int8_tree(net_j, fp, x0)
        model = port_int8(ViTClassifier(ViTConfig(
            **VIT, dropout=0.0, dtype=torch.float32, quant="int8"),
            N_CLASSES), tree)
    x = images(4, seed=6)
    want = jax.jit(lambda p, x: net_j.apply({"params": p}, x))(
        jax.tree.map(jnp.asarray, tree), x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (4, N_CLASSES) and got.dtype == torch.float32
    assert rel(got, want) < REL


def test_int8_videogpt_prefill_and_decode_match_jax():
    """The int8 VideoGPT's prefill (its logits and the cache it writes)
    and three decode steps (bias added before the cached attention)
    against JAX's. An fp32 ulp between the packages can move an activation
    across a rounding level of the dynamic int8 quantization, which moves
    the entries downstream of it by up to a level (1/127 of the row's
    largest): the cache is held in the mean, and each step starts from
    JAX's cache so that it is compared alone."""
    from vit_tpu.models.videogpt import VideoGPT as JaxVideoGPT
    from vit_tpu.models.videogpt import init_cache as jax_init_cache
    from vit_tpu_torch.models.videogpt import VideoGPT, init_cache

    cfg_j, cfg_t = videogpt_configs("float32", quant="int8")
    fp = videogpt_params(videogpt_configs("float32")[0])
    net_j = JaxVideoGPT(cfg_j)
    tree = jax_int8_tree(net_j, fp, jnp.zeros((1, 1, cfg_j.frame_size),
                                              jnp.int32))
    model = port_int8(VideoGPT(cfg_t), tree)
    p = jax.tree.map(jnp.asarray, tree)
    seq = np.concatenate([np.full((2, 1), cfg_t.codebook_size, np.int32),
                          codes((2, 44), cfg_t.codebook_size, seed=7)], 1)
    logits_j, mut = net_j.apply(
        {"params": p, "cache": jax_init_cache(net_j, p, 2)},
        jnp.asarray(seq[:, :41]), method=net_j.prefill, mutable=["cache"])
    with torch.no_grad():
        cache = init_cache(model, 2)
        logits, cache = model.prefill(torch.from_numpy(seq[:, :41]), cache)
    assert rel(logits, logits_j) < REL

    def jax_kv(i):
        kv = mut["cache"]["transformer"][f"layer_{i}"]["attn"]
        return [torch.from_numpy(np.array(kv[n])) for n in ("k", "v")]

    for i, kv in enumerate(cache):   # a level flip moves a few entries
        for got, want in zip(kv, jax_kv(i)):
            assert mean_rel(got[:, :, :41], want[:, :, :41]) < REL
    for pos in range(41, 44):
        for i, kv in enumerate(cache):
            for got, want in zip(kv, jax_kv(i)):
                got.copy_(want)
        logits_j, mut = net_j.apply(
            {"params": p, "cache": mut["cache"]},
            jnp.asarray(seq[:, pos:pos + 1]), pos, method=net_j.decode_step,
            mutable=["cache"])
        with torch.no_grad():
            logits, cache = model.decode_step(
                torch.from_numpy(seq[:, pos:pos + 1]), pos, cache)
        assert rel(logits, logits_j) < REL, pos


@pytest.mark.parametrize("rows", [1, 5, 16])
def test_int_mm_row_pad(rows):
    """``pad_rows`` to the card's 17 rows: the padded product's first rows
    equal the unpadded product, and zero rows quantize and multiply to
    zero."""
    gen = torch.Generator().manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 64), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (64, 24), generator=gen, dtype=torch.int8)
    padded = quant.pad_rows(a, quant.INT_MM_MIN_ROWS)
    assert padded.shape == (quant.INT_MM_MIN_ROWS, 64)
    y = torch._int_mm(padded, b)
    assert torch.equal(y[:rows], torch._int_mm(a, b))
    assert not y[rows:].any()
    assert quant.pad_rows(padded, quant.INT_MM_MIN_ROWS) is padded
    x = torch.zeros(3, 64)
    x[0] = torch.randn(64, generator=gen)
    out = quant.int8_matmul(x, b, torch.ones(24))
    assert not out[1:].any() and out[0].abs().max() > 0
