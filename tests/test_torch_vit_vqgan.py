"""Port parity for the ViT-VQGAN families on the CPU: ViT-VQGAN
(``models/vit_vqgan.py``) and the enhancing ViT-VQGAN
(``models/enhancing_vqgan.py``) against the JAX modules: the forward
(reconstruction, codes, quantizer loss), every parameter's gradient of the
L1 tokenizer loss, ``encode``/``decode_indices``, ``get_last_layer``, the
enhancing LayerNorm's eps (a control at torch's 1e-5 must fail), the bridge
both ways, a bf16 smoke run and three L1 tokenizer steps against JAX's
``make_tokenizer_train_step``.

Tiny sizes: the "tiny" preset (2 layers × 2 heads × 128, head_dim 64) for
ViT-VQGAN, the enhancing dims cut to the same (MLP 256); image 32, patch 8
(16 latents), a 64 × 12 codebook. JAX weights come from its init through
``vit_tpu_torch.bridge``, inputs from numpy seeds; the JAX side runs its XLA
attention, the port its kernels' plain versions. fp32 within 1e-3
(``REL``) unless a line says otherwise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (images, moved_params, scaled_err,
                                tiny_preset)
from vit_tpu.models.enhancing_vqgan import EnhancingViTVQGAN as JaxEnhancing
from vit_tpu.models.enhancing_vqgan import \
    EnhancingVQGANConfig as JaxEnhancingConfig
from vit_tpu.models.vit_vqgan import ViTVQGAN as JaxViTVQGAN
from vit_tpu.models.vit_vqgan import ViTVQGANConfig as JaxViTVQGANConfig
from vit_tpu_torch.bridge import (enhancing_state_dict_from_flax, flatten,
                                  flax_from_state_dict,
                                  vit_vqgan_state_dict_from_flax)
from vit_tpu_torch.losses.perceptual import LayerNorm
from vit_tpu_torch.models.enhancing_vqgan import (EnhancingViTVQGAN,
                                                  EnhancingVQGANConfig)
from vit_tpu_torch.models.vit_vqgan import ViTVQGAN, ViTVQGANConfig
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState
from vit_tpu_torch.train.step import make_tokenizer_train_step

REL = 1e-3
UPDATE_REL = 1e-2   # the three steps' update of each weight, relative
FAMILIES = ("vit_vqgan", "enhancing")
SHAPE = dict(image_size=32, patch_size=8, codebook_size=64, latent_dim=12)
ENHANCING_DIMS = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny models' small ops run several times
    slower across threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family(name: str, dtype: str = "float32"):
    """(JAX model, port class, port config, bridge function) of a family;
    call inside ``tiny_preset``."""
    if name == "vit_vqgan":
        cfg_j = JaxViTVQGANConfig(**SHAPE, transformer="tiny",
                                  dtype=getattr(jnp, dtype))
        cfg_t = ViTVQGANConfig(**SHAPE, transformer="tiny",
                               dtype=getattr(torch, dtype))
        return (JaxViTVQGAN(cfg_j), ViTVQGAN, cfg_t,
                vit_vqgan_state_dict_from_flax)
    cfg_j = JaxEnhancingConfig(**SHAPE, **ENHANCING_DIMS,
                               dtype=getattr(jnp, dtype))
    cfg_t = EnhancingVQGANConfig(**SHAPE, **ENHANCING_DIMS,
                                 dtype=getattr(torch, dtype))
    return JaxEnhancing(cfg_j), EnhancingViTVQGAN, cfg_t, \
        enhancing_state_dict_from_flax


@functools.lru_cache(maxsize=None)
def jax_params(name: str) -> dict:
    with tiny_preset():
        net_j = family(name)[0]
        params = jax.jit(net_j.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree.map(np.asarray, params)


def port(name: str, dtype: str = "float32"):
    """(JAX model, port model with the JAX weights, JAX params)."""
    params = jax_params(name)
    with tiny_preset():
        net_j, cls, cfg_t, bridge = family(name, dtype)
        model = cls(cfg_t, device="meta")
        model.load_state_dict(bridge(params, cfg_t), assign=True)
    return net_j, model.eval(), params


def l1_loss(recon, x, qloss):
    return (recon - x).abs().mean() + qloss


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_and_gradients_match_jax(name):
    """Reconstruction, codes and quantizer loss, and the gradient of the L1
    tokenizer loss at every parameter, within ``REL``."""
    net_j, model, params = port(name)
    x = images(2, seed=1)
    recon_j, idx_j, q_j = net_j.apply({"params": params}, jnp.asarray(x))

    def loss_j(p):
        recon, _, q = net_j.apply({"params": p}, jnp.asarray(x))
        return jnp.abs(recon - x).mean() + q

    grads_j = jax.jit(jax.grad(loss_j))(jax.tree.map(jnp.asarray, params))
    model.requires_grad_(True)
    recon, idx, q = model(torch.from_numpy(x))
    l1_loss(recon, torch.from_numpy(x), q).backward()
    assert recon.shape == (2, 32, 32, 3) and recon.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert idx.dtype == torch.int32 and idx.shape == (2, 16)
    assert scaled_err(recon.detach(), recon_j) <= REL
    np.testing.assert_allclose(q.item(), float(q_j), rtol=REL)
    got = flatten(flax_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()}))
    ref = flatten(jax.tree.map(np.asarray, grads_j))
    assert got.keys() == ref.keys()
    for k in ref:
        assert scaled_err(got[k], ref[k]) <= REL, k


@pytest.mark.parametrize("name", FAMILIES)
def test_encode_and_decode_indices_match_jax(name):
    net_j, model, params = port(name)
    x = images(3, seed=2)
    idx_j = net_j.apply({"params": params}, jnp.asarray(x),
                        method=net_j.encode)
    with torch.no_grad():
        idx = model.encode(torch.from_numpy(x))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        img = model.decode_indices(idx)
    img_j = net_j.apply({"params": params}, idx_j,
                        method=net_j.decode_indices)
    assert scaled_err(img, img_j) <= REL


@pytest.mark.parametrize("name", FAMILIES)
def test_bridge_round_trip(name):
    """The port's state dict back through ``flax_from_state_dict`` is the
    JAX tree, every leaf bit for bit: the enhancing blocks'
    ``blocks.{i}.attn_norm`` turn back into ``attn_norm_{i}``."""
    _, model, params = port(name)
    back = flatten(flax_from_state_dict(model.state_dict()))
    ref = flatten(params)
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    if name == "enhancing":
        assert "encoder.transformer.blocks.1.ff_norm.weight" in \
            model.state_dict()
        assert "encoder/transformer/ff_norm_1/scale" in ref


def test_get_last_layer_is_the_pixel_head():
    net_j, model, params = port("enhancing")
    kernel = net_j.apply({"params": params}, method=net_j.get_last_layer)
    np.testing.assert_array_equal(model.get_last_layer().detach().numpy().T,
                                  np.asarray(kernel))
    assert model.get_last_layer() is model.decoder.to_pixel.weight


@pytest.mark.parametrize("eps,agrees", [(1e-6, True), (1e-5, False)])
def test_enhancing_layernorm_eps(eps, agrees):
    """The enhancing LayerNorm against flax's ``nn.LayerNorm`` on rows of
    variance about 1e-6, where eps decides the output: flax's 1e-6 agrees
    within 1e-5, torch's default 1e-5 (the control) is far off. Every
    LayerNorm of the model carries 1e-6."""
    import flax.linen as fnn

    rng = np.random.default_rng(3)
    x = (1e-3 * rng.normal(size=(4, 128))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=128)).astype(np.float32)
    bias = (0.1 * rng.normal(size=128)).astype(np.float32)
    ref = fnn.LayerNorm(dtype=jnp.float32).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    ln = LayerNorm(128, torch.float32, eps=eps)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        out = ln(torch.from_numpy(x))
    err = scaled_err(out, ref)
    assert (err <= 1e-5) if agrees else (err > 1e-1), err
    _, model, _ = port("enhancing")
    norms = [m for m in model.modules() if isinstance(m, LayerNorm)]
    assert len(norms) == 2 * (2 * ENHANCING_DIMS["depth"] + 1)
    assert all(m.eps == 1e-6 for m in norms)


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_smoke(name):
    """bf16 compute with the JAX weights: a forward and backward of the L1
    loss, finite, fp32 reconstruction and bf16 activations inside."""
    _, model, _ = port(name, "bfloat16")
    model.train().requires_grad_(True)
    x = torch.from_numpy(images(2, seed=4))
    recon, idx, q = model(x)
    loss = l1_loss(recon, x, q)
    loss.backward()
    assert recon.dtype == torch.float32 and recon.shape == x.shape
    assert torch.isfinite(loss) and idx.shape == (2, 16)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    enc = model.encoder.vit if name == "vit_vqgan" else model.encoder
    with torch.no_grad():
        assert enc(x).dtype == torch.bfloat16


@pytest.mark.parametrize("name", FAMILIES)
def test_l1_tokenizer_steps_match_jax(name):
    """Three fp32 steps of ``make_tokenizer_train_step(pixel_loss="l1")``
    against the jitted JAX step from the same weights and batches: metrics,
    reconstruction and usage each step, the codes before it, then every
    parameter and its update."""
    from vit_tpu.train.optim import make_optimizer as jax_make_optimizer
    from vit_tpu.train.state import TrainState as JaxTrainState
    from vit_tpu.train.step import \
        make_tokenizer_train_step as jax_make_step

    net_j, model, params = port(name)
    model.train().requires_grad_(True)
    opt = dict(lr=1e-4, warmup_steps=1, train_steps=1000, min_lr=1e-5,
               weight_decay=1e-4, clip_norm=1.0)
    step_j = jax.jit(jax_make_step(net_j, pixel_loss="l1"))
    state_j = JaxTrainState.create(jax.tree.map(jnp.asarray, params),
                                   jax_make_optimizer(**opt))
    usage_j = jnp.zeros((SHAPE["codebook_size"],))
    state = TrainState.create(model, make_optimizer(**opt))
    usage = torch.zeros(SHAPE["codebook_size"])
    step = make_tokenizer_train_step(model, pixel_loss="l1")
    for i in range(3):
        x = images(4, seed=30 + i)
        idx_j = net_j.apply({"params": state_j.params}, jnp.asarray(x),
                            method=net_j.encode)
        with torch.no_grad():
            idx = model.encode(torch.from_numpy(x))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        state_j, usage_j, m_j, recon_j = step_j(state_j, jnp.asarray(x),
                                                usage_j, jax.random.PRNGKey(0))
        _, usage, m, recon = step(state, torch.from_numpy(x), usage)
        assert set(m) == set(m_j)
        for k in m_j:
            np.testing.assert_allclose(m[k].item(), float(m_j[k]), rtol=REL,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j),
                                   atol=REL, rtol=0)
        np.testing.assert_array_equal(usage.numpy(), np.asarray(usage_j))
    assert state.step.item() == 3
    got = flatten(flax_from_state_dict(model.state_dict()))
    ref = flatten(jax.tree.map(np.asarray, state_j.params))
    start = flatten(params)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=REL, rtol=0,
                                   err_msg=k)
        moved, moved_ref = moved_params(k, got[k], start[k], ref[k])
        assert np.linalg.norm(moved_ref) > 0, k
        rel = np.linalg.norm(moved - moved_ref) / np.linalg.norm(moved_ref)
        assert rel <= UPDATE_REL, (k, rel)
