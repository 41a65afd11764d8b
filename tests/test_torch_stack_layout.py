"""The JAX package's scanned and pipelined stack layouts read into the port's
unrolled modules, a JAX export directory read by ``load_exported``, and the
int8 scales divided as the JAX package divides them.

  - ``vit_tpu_torch.bridge``'s copies of ``stack_layer_params`` ...
    ``convert_stack_layout`` and ``convert_enhancing_layout`` against the JAX
    functions, both ways;
  - a tiny TiTok, VideoGPT and enhancing ViT-VQGAN initialised by JAX with
    ``scan_layers=True`` (and that tree pipelined into 2 stages) load into
    the port with the state dict of the unrolled tree, and their outputs
    hold the JAX scanned model's within 1e-5 (fp32);
  - a JAX CPU export (``vit_tpu.serve.export.export_tokenizer``) of a
    scanned tiny TiTok loads through ``load_exported``: its config from the
    manifest and ``weights.npz``, its encode equal to the JAX export's;
  - ``jax_config`` for every family it can build, and its refusals naming
    the field;
  - ``core/quant.py:divide`` and the scales of ``quantize_kernel`` and
    ``int8_matmul`` bit for bit against numpy's float32 division, at absmax
    values where a multiply by the reciprocal differs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.core.transformer as jax_tf
import vit_tpu.models.enhancing_vqgan as jax_enh
from torch_port_helpers import TITOK, images, tiny_preset
from vit_tpu_torch import bridge
from vit_tpu_torch.core import quant
from vit_tpu_torch.models.enhancing_vqgan import (EnhancingViTVQGAN,
                                                  EnhancingVQGANConfig)
from vit_tpu_torch.models.titok import TiTok, TiTokConfig
from vit_tpu_torch.models.videogpt import VideoGPT, VideoGPTConfig
from vit_tpu_torch.serve.export import FAMILIES, jax_config, load_exported

TOL = 1e-5
VIDEOGPT = dict(frame_size=8, codebook_size=64, transformer="tiny",
                max_frames=6)
ENHANCING = dict(image_size=32, patch_size=8, codebook_size=64, latent_dim=12,
                 dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256)


@pytest.fixture(scope="module", autouse=True)
def setting():
    with tiny_preset():
        yield


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def same_state(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def transformer_sites(tree: dict, path=()):
    """Paths of every subtree that holds a stack (``layers`` or
    ``layer_0``)."""
    if not isinstance(tree, dict):
        return []
    if "layers" in tree or "layer_0" in tree or "attn_0" in tree:
        return [path]
    return [p for k, v in tree.items()
            for p in transformer_sites(v, path + (k,))]


def map_sites(tree: dict, fn) -> dict:
    """``tree`` with ``fn`` applied to every stack subtree."""
    out = dict(tree)
    for path in transformer_sites(tree):
        node = out
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        node[path[-1]] = fn(node[path[-1]])
    return out


@pytest.mark.parametrize("leaf", ["numpy", "torch"])
def test_layout_helpers_match_jax(leaf):
    rng = np.random.default_rng(0)
    unrolled = {f"layer_{i}": {"attn": {"qkv": {
        "kernel": rng.normal(size=(4, 12)).astype(np.float32),
        "bias": rng.normal(size=(12,)).astype(np.float32)}}}
        for i in range(4)}
    unrolled["final"] = {"scale": np.ones(4, np.float32)}
    conv = (lambda x: x) if leaf == "numpy" else torch.from_numpy
    port_in = jax.tree.map(conv, unrolled)
    scanned_j = np_tree(jax_tf.stack_layer_params(unrolled, 4))
    piped_j = np_tree(jax_tf.pipeline_layer_params(scanned_j, 2))
    scanned = bridge.stack_layer_params(port_in, 4)
    piped = bridge.convert_stack_layout(port_in, True, 2)

    def equal(a, b):
        fa, fb = bridge._flat(a), bridge._flat(b)
        return fa.keys() == fb.keys() and all(
            np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)

    assert equal(scanned, scanned_j) and equal(piped, piped_j)
    assert equal(bridge.convert_stack_layout(piped, True), scanned_j)
    assert equal(bridge.convert_stack_layout(piped, False), unrolled)
    assert equal(bridge.unrolled({"t": piped}), {"t": unrolled})
    assert bridge.convert_stack_layout(port_in, False) == port_in
    # the enhancing block's flat names
    flat = {f"{b}_{i}": {"kernel": rng.normal(size=(4, 4)).astype(np.float32)}
            for b in ("attn_norm", "attn", "ff_norm", "ff1", "ff2")
            for i in range(3)}
    flat["final_norm"] = {"scale": np.ones(4, np.float32)}
    stacked_j = np_tree(jax_enh.convert_enhancing_layout(flat, True))
    stacked = bridge.convert_enhancing_layout(jax.tree.map(conv, flat), True)
    assert equal(stacked, stacked_j)
    assert equal(bridge.unrolled({"transformer": stacked}),
                 {"transformer": flat})


def jax_titok(**kw):
    from vit_tpu.models.titok import TiTok as JaxTiTok
    from vit_tpu.models.titok import TiTokConfig as JaxTiTokConfig

    return JaxTiTok(JaxTiTokConfig(**TITOK, dtype=jnp.float32,
                                   attn_impl="xla", **kw))


@functools.lru_cache(maxsize=None)
def scanned_titok():
    net = jax_titok(scan_layers=True)
    params = np_tree(jax.jit(net.init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 32, 32, 3)))["params"])
    return net, params


@pytest.mark.parametrize("layout", ["scan", "pipeline"])
def test_scanned_titok_loads_unrolled(layout):
    net, params = scanned_titok()
    assert "layers" in params["enc"]["vit"]["transformer"]
    tree = params if layout == "scan" else map_sites(
        params, lambda t: np_tree(jax_tf.pipeline_layer_params(t, 2)))
    cfg = TiTokConfig(**TITOK, dtype=torch.float32)
    state = bridge.state_dict_from_flax(tree, cfg)
    unrolled = map_sites(params, lambda t: np_tree(
        jax_tf.convert_stack_layout(t, scan_layers=False)))
    assert "layer_1" in unrolled["dec"]["vit"]["transformer"]
    assert same_state(state, bridge.state_dict_from_flax(unrolled, cfg))
    model = TiTok(cfg, device="meta")
    model.load_state_dict(state, assign=True)
    x = images(2, seed=3)
    recon_j, idx_j, _ = net.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        recon, idx, _ = model.eval()(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("layout", ["scan", "pipeline"])
def test_scanned_videogpt_loads_unrolled(layout):
    from vit_tpu.models.videogpt import VideoGPT as JaxVideoGPT
    from vit_tpu.models.videogpt import VideoGPTConfig as JaxVideoGPTConfig

    net = JaxVideoGPT(JaxVideoGPTConfig(**VIDEOGPT, dtype=jnp.float32,
                                        attn_impl="xla", scan_layers=True))
    tokens = np.random.default_rng(4).integers(
        0, 64, (2, 3, VIDEOGPT["frame_size"]), dtype=np.int32)
    params = np_tree(jax.jit(net.init)(jax.random.PRNGKey(1),
                                       jnp.asarray(tokens[:1]))["params"])
    tree = params if layout == "scan" else map_sites(
        params, lambda t: np_tree(jax_tf.pipeline_layer_params(t, 2)))
    cfg = VideoGPTConfig(**VIDEOGPT, dtype=torch.float32, scan_layers=True,
                         pp_stages=2 if layout == "pipeline" else 0)
    model = VideoGPT(cfg, device="meta")
    model.load_state_dict(bridge.videogpt_state_dict_from_flax(tree, cfg),
                          assign=True)
    out_j = net.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(tokens))
    logits_j, logits = (o[0] if isinstance(o, tuple) else o
                        for o in (out_j, out))
    np.testing.assert_allclose(np.asarray(logits), np.asarray(logits_j),
                               atol=TOL, rtol=TOL)


def test_scanned_enhancing_loads_unrolled():
    net = jax_enh.EnhancingViTVQGAN(jax_enh.EnhancingVQGANConfig(
        **ENHANCING, dtype=jnp.float32, scan_layers=True))
    params = np_tree(jax.jit(net.init)(jax.random.PRNGKey(2),
                                       jnp.zeros((1, 32, 32, 3)))["params"])
    assert "layers" in params["encoder"]["transformer"]
    cfg = EnhancingVQGANConfig(**ENHANCING, dtype=torch.float32)
    state = bridge.enhancing_state_dict_from_flax(params, cfg)
    unrolled = map_sites(params, lambda t: np_tree(
        jax_enh.convert_enhancing_layout(t, False)))
    assert same_state(state, bridge.enhancing_state_dict_from_flax(unrolled,
                                                                   cfg))
    model = EnhancingViTVQGAN(cfg, device="meta")
    model.load_state_dict(state, assign=True)
    x = images(2, seed=5)
    recon_j, idx_j, _ = net.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        recon, idx, _ = model.eval()(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=TOL,
                               rtol=TOL)


def test_jax_export_of_a_scanned_titok_loads(tmp_path):
    """The JAX export bakes its config's dtype: the default bf16 here, as
    ``jax_config`` assumes."""
    from vit_tpu.models.titok import TiTokConfig as JaxTiTokConfig
    from vit_tpu.serve.export import export_tokenizer
    from vit_tpu.serve.export import load_exported as jax_load_exported
    from vit_tpu.train.checkpoint import Checkpointer
    from vit_tpu.train.optim import make_optimizer
    from vit_tpu.train.state import TrainState

    cfg_j = JaxTiTokConfig(**TITOK, attn_impl="xla", scan_layers=True)
    params = scanned_titok()[1]
    ckpt = Checkpointer(str(tmp_path / "ckpt"), mode="min")
    ckpt.save_if_best(TrainState.create(
        jax.tree.map(jnp.asarray, params),
        make_optimizer(1e-4, 1, 10, 1e-5, 0.0)), 1.0, config=cfg_j)
    ckpt.finalize()
    out = export_tokenizer(str(tmp_path / "ckpt"), str(tmp_path / "export"),
                           bs=2, platforms=("cpu",))
    served_j = jax_load_exported(out)
    assert "config" not in served_j["manifest"]
    served = load_exported(str(out), "cpu")
    x = images(2, seed=6)
    idx_j = np.asarray(served_j["encode"](jnp.asarray(x)))
    idx = served["encode"](x).numpy()
    np.testing.assert_array_equal(idx, idx_j)
    img_j = np.asarray(served_j["decode"](jnp.asarray(idx_j)))
    img = served["decode"](idx).float().numpy()
    # both compute in bf16 under different fusion schedules (the JAX
    # package's own export test holds its served decode so)
    np.testing.assert_allclose(img, img_j, rtol=0.05, atol=0.03)
    assert served["_in_avals"]["decode"] == [((2, 8), "int32")]


def meta_tree(name: str, cfg, *args) -> dict:
    return bridge.flax_tree(FAMILIES[name][1](cfg, *args,
                                              device="meta").state_dict())


JAX_MANIFESTS = {
    "titok": dict(TITOK, _manifest=dict(image_size=32, n_tokens=8)),
    "vit_vqgan": dict(image_size=32, patch_size=8, codebook_size=64,
                      latent_dim=12, transformer="tiny",
                      _manifest=dict(image_size=32, n_tokens=16)),
    "llamagen_titok": dict(vq_codebook_size=64, vq_latent_tokens=16,
                           latent_tokens=8, codebook_size=32, latent_dim=12,
                           transformer="tiny", _manifest=dict(n_tokens=8)),
    "vit_classifier": dict(image_size=32, in_channels=3, patch_size=8,
                           transformer="tiny", extra_tokens=1, dropout=0.0,
                           _manifest=dict(image_size=32, num_classes=10)),
    "videogpt": dict(VIDEOGPT, _manifest=dict(frame_size=8,
                                              codebook_size=64)),
}


@pytest.mark.parametrize("name", sorted(JAX_MANIFESTS))
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_jax_config_rebuilds_each_family(name, quantize):
    fields = dict(JAX_MANIFESTS[name])
    manifest = dict(fields.pop("_manifest"), model=name, quantize=quantize)
    cfg = FAMILIES[name][0](**fields, quant=quantize)
    args = (10,) if name == "vit_classifier" else ()
    tree = meta_tree(name, cfg, *args)
    built = jax_config(manifest, tree)
    for k, v in fields.items():
        assert getattr(built, k) == v, k
    assert built.dtype == torch.bfloat16 and built.quant == quantize


@pytest.mark.parametrize("name, field", [
    ("titok", "fsq_levels"), ("tatitok", "use_l2_norm"),
    ("enhancing", "heads")])
def test_jax_config_refuses_what_the_export_leaves_open(name, field):
    if name == "titok":
        cfg = TiTokConfig(**{**TITOK, "codebook_size": 64}, quantizer="fsq",
                          fsq_levels=(4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4))
        tree = meta_tree(name, cfg)
        assert "quant" not in tree
    else:
        tree = {}
    with pytest.raises(ValueError, match=f"'{field}'"):
        jax_config(dict(model=name, image_size=32, n_tokens=8), tree)


def differing_absmax(n: int, seed: int) -> np.ndarray:
    """float32 values a with a / 127 ≠ a · (1 / 127) in float32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.01, 10.0, 100 * n).astype(np.float32)
    inv = np.float32(1.0) / np.float32(127.0)
    a = a[(a / np.float32(127.0)) != (a * inv)][:n]
    assert len(a) == n
    return a


def test_int8_scales_divide_as_the_reference():
    a = differing_absmax(64, 0)
    np.testing.assert_array_equal(
        quant.divide(torch.from_numpy(a), 127.0).numpy(), a / np.float32(127))
    # a kernel whose column absmax is a (a one-hot row of each column)
    w = np.zeros((16, 64), np.float32)
    w[np.arange(64) % 16, np.arange(64)] = a * np.where(
        np.arange(64) % 2, 1, -1)
    _, scale = quant.quantize_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(scale.numpy(), a / np.float32(127))
    # activation rows whose absmax is a, through int8_matmul's s_x: a row of
    # x against the identity kernel at unit scale gives x_q · s_x
    x = np.zeros((64, 16), np.float32)
    x[:, 0] = a
    x[:, 1] = a * np.float32(0.5)
    eye = torch.eye(16, dtype=torch.int8)
    y = quant.int8_matmul(torch.from_numpy(x), eye, torch.ones(16))
    s_x = a / np.float32(127)
    np.testing.assert_array_equal(y[:, 0].numpy(), np.float32(127) * s_x)
    # the clustering VQ's usage mean divides by the row count
    counts = torch.arange(64, dtype=torch.float32)
    np.testing.assert_array_equal(quant.divide(counts, 48).numpy(),
                                  np.arange(64, dtype=np.float32)
                                  / np.float32(48))
