"""Port parity for the LlamaGen family on the CPU: the frozen LlamaGen VQ
(``models/llamagen_vq.py``) and LlamaGen-TiTok
(``models/llamagen_titok.py``) against the JAX modules.

The VQ at ``tests/test_llamagen_vq.py``'s tiny layout (ch 32, ``ch_mult``
(1, 2), one res block a level, attention at the 64-channel level of the
encoder and twice at the decoder's first level, z 16, 64 codes × 8), with
weights drawn as that test draws them: codes equal, images within 1e-4,
``_infer_config`` equal to JAX's; one ``.pt`` written by
``llamagen_state_dict`` read by both packages' ``load_llamagen_vq``; that
test's torch twin (LlamaGen's own module layout) read by the port's loader;
the bridge; VQ-16's layout inferred back from its keys. LlamaGen-TiTok at
the "tiny" preset (2 layers × 2 heads × 128) over 16 codes of 64, 8
latents, a 32 × 12 codebook: logits, codes, quantizer loss and every
gradient of the CE loss within 1e-3 (``REL``), and four CE micro-steps
under ``--micro_steps 2`` (``MultiSteps``) against the JAX entry's step
under ``optax.MultiSteps``. fp32 throughout."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import codes, moved_params, scaled_err, tiny_preset
from vit_tpu.models.llamagen_titok import LlamaGenTiTok as JaxLlamaGenTiTok
from vit_tpu.models.llamagen_titok import \
    LlamaGenTiTokConfig as JaxLlamaGenTiTokConfig
from vit_tpu.models.llamagen_vq import _infer_config as jax_infer_config
from vit_tpu.models.llamagen_vq import \
    convert_llamagen_state_dict as jax_convert
from vit_tpu.models.llamagen_vq import load_llamagen_vq as jax_load
from vit_tpu_torch.bridge import (flatten, flax_from_state_dict,
                                  llamagen_titok_state_dict_from_flax,
                                  llamagen_vq_state_dict_from_flax)
from vit_tpu_torch.models.llamagen_titok import (LlamaGenTiTok,
                                                 LlamaGenTiTokConfig)
from vit_tpu_torch.models.llamagen_vq import (LlamaGenVQ, LlamaGenVQConfig,
                                              _infer_config,
                                              convert_llamagen_state_dict,
                                              llamagen_key,
                                              llamagen_state_dict,
                                              load_llamagen_vq, vq16_config)

REL = 1e-3
IMG_ATOL = 1e-4
VQ_TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, enc_attn=(0, 1),
               dec_attn=(2, 0), z_channels=16, embed_dim=8, n_embed=64)
TITOK = dict(vq_codebook_size=64, vq_latent_tokens=16, latent_tokens=8,
             codebook_size=32, latent_dim=12, transformer="tiny")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vq_images(n: int, seed: int, size: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def tiny_vq() -> LlamaGenVQ:
    """The tiny VQ with ``tests/test_llamagen_vq.py``'s weight draw: norm
    scales 1 + 0.1·N(0, 1), every other tensor 0.1·N(0, 1)."""
    model = LlamaGenVQ(LlamaGenVQConfig(**VQ_TINY))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model.eval().requires_grad_(False)


def test_llamagen_vq_matches_jax():
    """The JAX converter reads the port's LlamaGen-layout state dict: the
    same config, codes equal, decoded images within ``IMG_ATOL``."""
    model = tiny_vq()
    sd = llamagen_state_dict(model)
    cfg_j, params = jax_convert(sd)
    from vit_tpu.models.llamagen_vq import LlamaGenVQ as JaxLlamaGenVQ

    net_j = JaxLlamaGenVQ(cfg_j)
    cfg = _infer_config(sd)
    for field in ("ch", "ch_mult", "num_res_blocks", "enc_attn", "dec_attn",
                  "z_channels", "embed_dim", "n_embed", "l2_norm",
                  "downsample_factor"):
        assert tuple(np.atleast_1d(getattr(cfg, field))) == tuple(
            np.atleast_1d(getattr(cfg_j, field))), field
    x = vq_images(3, seed=1)
    idx_j = np.asarray(net_j.apply({"params": params}, jnp.asarray(x),
                                   method="encode"))
    idx = model.encode(torch.from_numpy(x))
    assert idx.dtype == torch.int32 and idx.shape == (3, 64)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    img_j = net_j.apply({"params": params}, jnp.asarray(idx_j),
                        method="decode_indices")
    img = model.decode_indices(idx)
    assert img.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j),
                               atol=IMG_ATOL, rtol=REL)


def test_one_pt_file_gives_the_same_codes_in_both_packages(tmp_path):
    """A ``{"model": state_dict}`` file from ``llamagen_state_dict``, read
    by the JAX ``load_llamagen_vq`` and the port's: the same codes, and the
    port's weights are the written ones bit for bit."""
    model = tiny_vq()
    path = tmp_path / "vq_ds2_c2i.pt"
    torch.save({"model": llamagen_state_dict(model)}, path)
    net_j, params = jax_load(str(path))
    loaded = load_llamagen_vq(str(path))
    assert not loaded.training and not any(p.requires_grad
                                           for p in loaded.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    x = vq_images(4, seed=2)
    idx_j = np.asarray(net_j.apply({"params": params}, jnp.asarray(x),
                                   method="encode"))
    np.testing.assert_array_equal(loaded.encode(torch.from_numpy(x)).numpy(),
                                  idx_j)


def test_reads_llamagen_module_layout(tmp_path):
    """``tests/test_llamagen_vq.py``'s torch twin, built with LlamaGen's own
    modules (``conv_blocks[i].res/attn/downsample.conv``, ``mid``,
    ``quantize.embedding``) and its forward: the port's loader takes its
    checkpoint, and its codes and images are the twin's."""
    from test_llamagen_vq import TorchVQModel

    twin = TorchVQModel().eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in twin.named_parameters():
            p.copy_((1.0 if "norm" in name and name.endswith("weight")
                     else 0.0) + 0.1 * torch.randn(p.shape, generator=g))
    path = tmp_path / "twin.pt"
    torch.save({"model": twin.state_dict()}, path)
    model = load_llamagen_vq(str(path))
    assert model.config.enc_attn == (0, 1)
    assert model.config.dec_attn == (2, 0)
    x = vq_images(2, seed=3)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        ref = twin.encode_indices(xt)
        ref_img = twin.decode_indices(ref).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(model.encode(torch.from_numpy(x)).numpy(),
                                  ref.numpy())
    np.testing.assert_allclose(model.decode_indices(ref).numpy(),
                               ref_img.numpy(), atol=IMG_ATOL, rtol=REL)
    assert set(llamagen_state_dict(model)) == set(twin.state_dict())


def test_bridge_matches_the_converter():
    """JAX params through ``llamagen_vq_state_dict_from_flax`` (HWIO →
    OIHW, ``scale`` → ``weight``) are the port's own weights, and back."""
    model = tiny_vq()
    cfg_j, params = jax_convert(llamagen_state_dict(model))
    params = jax.tree.map(np.asarray, params)
    sd = llamagen_vq_state_dict_from_flax(params, model.config)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    back = flatten(flax_from_state_dict(model.state_dict()))
    assert back.keys() == flatten(params).keys()


def test_vq16_layout_round_trips_through_its_keys():
    """VQ-16's widths with attention where LlamaGen places it: its
    LlamaGen keys infer the same config (shapes only, on the meta
    device), the last encoder level has two attention blocks and the
    first decoder level three, and ``nin_shortcut`` appears only where the
    channel count changes."""
    cfg = vq16_config()
    sd = {llamagen_key(k): v for k, v in
          LlamaGenVQ(cfg, device="meta").state_dict().items()}
    back = _infer_config(sd)
    for field in ("ch", "ch_mult", "num_res_blocks", "enc_attn", "dec_attn",
                  "z_channels", "embed_dim", "n_embed"):
        assert getattr(back, field) == getattr(cfg, field), field
    assert cfg.enc_attn == (0, 0, 0, 0, 2) and cfg.dec_attn == (3, 0, 0, 0, 0)
    assert cfg.downsample_factor == 16
    shortcuts = sorted(k for k in sd if "nin_shortcut.weight" in k)
    assert shortcuts == [
        "decoder.conv_blocks.1.res.0.nin_shortcut.weight",
        "decoder.conv_blocks.3.res.0.nin_shortcut.weight",
        "encoder.conv_blocks.2.res.0.nin_shortcut.weight",
        "encoder.conv_blocks.4.res.0.nin_shortcut.weight"]


def test_converter_refuses_a_missing_or_misshapen_key():
    sd = llamagen_state_dict(tiny_vq())
    extra = dict(sd, **{"quantize.codebook_used": torch.zeros(8)})
    assert convert_llamagen_state_dict(extra)[0].n_embed == 64
    bad = dict(sd)
    del bad["decoder.mid.1.q.weight"]
    with pytest.raises(KeyError, match="decoder.mid.1.q.weight"):
        convert_llamagen_state_dict(bad)
    bad = dict(sd, **{"encoder.norm_out.bias": torch.zeros(3)})
    with pytest.raises(ValueError, match="encoder.norm_out.bias"):
        convert_llamagen_state_dict(bad)


@functools.lru_cache(maxsize=None)
def titok_params() -> dict:
    with tiny_preset():
        cfg_j = JaxLlamaGenTiTokConfig(**TITOK, dtype=jnp.float32)
        params = jax.jit(JaxLlamaGenTiTok(cfg_j).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def titok_pair():
    """(JAX LlamaGen-TiTok, the port's with the same weights, params)."""
    params = titok_params()
    with tiny_preset():
        net_j = JaxLlamaGenTiTok(JaxLlamaGenTiTokConfig(**TITOK,
                                                        dtype=jnp.float32))
        cfg = LlamaGenTiTokConfig(**TITOK, dtype=torch.float32)
        model = LlamaGenTiTok(cfg, device="meta")
        model.load_state_dict(llamagen_titok_state_dict_from_flax(params,
                                                                  cfg),
                              assign=True)
    return net_j, model, params


def ce(logits, x):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits.reshape(-1, logits.shape[-1]), x.reshape(-1)).mean()


def test_llamagen_titok_forward_and_gradients_match_jax():
    net_j, model, params = titok_pair()
    x = codes((3, 16), 64, seed=4)
    logits_j, idx_j, q_j = net_j.apply({"params": params}, jnp.asarray(x))

    def loss_j(p):
        logits, _, q = net_j.apply({"params": p}, jnp.asarray(x))
        return ce(logits, jnp.asarray(x)) + q

    grads_j = jax.jit(jax.grad(loss_j))(jax.tree.map(jnp.asarray, params))
    logits, idx, q = model(torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 64), torch.from_numpy(x).reshape(-1).long()) + q
    loss.backward()
    assert logits.shape == (3, 16, 64) and logits.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert scaled_err(logits.detach(), logits_j) <= REL
    np.testing.assert_allclose(q.item(), float(q_j), rtol=REL)
    np.testing.assert_allclose(loss.item(), float(loss_j(params)), rtol=REL)
    got = flatten(flax_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()}))
    ref = flatten(jax.tree.map(np.asarray, grads_j))
    assert got.keys() == ref.keys()
    for k in ref:
        assert scaled_err(got[k], ref[k]) <= REL, k
    with torch.no_grad():
        np.testing.assert_array_equal(model.encode(torch.from_numpy(x))
                                      .numpy(), np.asarray(idx_j))
        dec = model.decode_indices(idx)
    dec_j = net_j.apply({"params": params}, idx_j,
                        method=net_j.decode_indices)
    assert scaled_err(dec, dec_j) <= REL


def test_ce_micro_steps_match_jax():
    """Four micro-steps of ``make_llamagen_titok_train_step`` under
    ``MultiSteps(k=2)`` against ``train_llamagen_titok.py``'s step under
    ``optax.MultiSteps``, from the same weights and code batches: the
    metrics of each micro-step, the usage bitmap, then every parameter
    after the two updates."""
    from vit_tpu.train.optim import make_optimizer as jax_make_optimizer
    from vit_tpu.train.state import TrainState as JaxTrainState
    from vit_tpu_torch.train.optim import MultiSteps, make_optimizer
    from vit_tpu_torch.train.state import TrainState
    from vit_tpu_torch.train.step import make_llamagen_titok_train_step

    net_j, model, params = titok_pair()
    model.train().requires_grad_(True)
    opt = dict(lr=1e-3, warmup_steps=1, train_steps=100, min_lr=1e-4,
               weight_decay=1e-4, clip_norm=1.0)
    state_j = JaxTrainState.create(
        jax.tree.map(jnp.asarray, params),
        optax.MultiSteps(jax_make_optimizer(**opt), every_k_schedule=2))

    @jax.jit
    def step_j(state, x, usage):
        def loss_fn(p):
            logits, indices, q = net_j.apply({"params": p}, x, False)
            recon = ce(logits, x)
            return recon + q, (indices, recon, q)

        (loss, (indices, recon, q)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        state = state.apply_gradients(grads=grads)
        usage = usage.at[indices.reshape(-1)].set(1.0)
        return state, usage, {"train/loss": loss, "train/recon_loss": recon,
                              "train/quant_loss": q,
                              "train/codebook_usage": usage.mean()}

    usage_j = jnp.zeros((TITOK["codebook_size"],))
    state = TrainState.create(model, MultiSteps(make_optimizer(**opt), 2))
    usage = torch.zeros(TITOK["codebook_size"])
    step = make_llamagen_titok_train_step(model)
    for i in range(4):
        x = codes((2, 16), 64, seed=10 + i)
        state_j, usage_j, m_j = step_j(state_j, jnp.asarray(x), usage_j)
        _, usage, m, idx = step(state, torch.from_numpy(x), usage)
        assert set(m) == set(m_j) and idx.shape == (2, 8)
        for k in m_j:
            np.testing.assert_allclose(m[k].item(), float(m_j[k]), rtol=REL,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(usage.numpy(), np.asarray(usage_j))
    assert state.step.item() == 4 and state.opt_state.mini_step == 0
    got = flatten(flax_from_state_dict(model.state_dict()))
    ref = flatten(jax.tree.map(np.asarray, state_j.params))
    start = flatten(params)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=REL, rtol=0,
                                   err_msg=k)
        moved, moved_ref = moved_params(k, got[k], start[k], ref[k])
        assert np.linalg.norm(moved_ref) > 0, k
        assert (np.linalg.norm(moved - moved_ref)
                <= 1e-2 * np.linalg.norm(moved_ref)), k
