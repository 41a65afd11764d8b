"""Shared set-up for the ``test_torch_*`` parity tests: a tiny transformer
preset registered in both packages, the matching TiTok and VideoGPT configs,
a tiny ConvNeXt perceptual net, JAX weights carried into the port through the
bridge, the JAX train steps, seeded numpy inputs, and a count of the fused
kernels' plain-version calls."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.core.config as jax_config
import vit_tpu_torch.core.config as torch_config
from vit_tpu.models.titok import TiTok as JaxTiTok
from vit_tpu.models.titok import TiTokConfig as JaxTiTokConfig
from vit_tpu_torch.bridge import state_dict_from_flax
from vit_tpu_torch.kernels import fc_grad as k_fc
from vit_tpu_torch.kernels import ln_matmul as k_lnmm
from vit_tpu_torch.models.titok import TiTok, TiTokConfig

# 2 layers, 2 heads, width 128: head_dim 64, so the packed kernel path applies
TINY = dict(n_layers=2, n_heads=2, n_embd=128)
# image 32, patch 8 (16 patches), K 8: S = 24 in both encoder and decoder
TITOK = dict(image_size=32, patch_size=8, latent_tokens=8, codebook_size=64,
             latent_dim=12, transformer="tiny")
# VideoGPT with the tiny transformer swapped in after construction, as
# tests/test_videogpt.py builds its tiny config: 13 frames of 64 codes make
# S = 832 > 768, so attention takes the unpacked path (K6, K7/K8)
VIDEOGPT = dict(frame_size=64, codebook_size=64, transformer="S",
                max_frames=13)
# ConvNeXt with one block per stage; the tests set the fused-tail gate to 64
# so the last stage (C 128) takes the unfused path, as ConvNeXt-S's stage 3
CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), num_classes=10)
TINY_FUSED_DIM = 64


@contextlib.contextmanager
def tiny_preset():
    """Register the "tiny" preset in both packages' preset dicts."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_config.transformer_configs, "tiny",
                   lambda **kw: jax_config.TransformerConfig(**TINY, **kw))
        mp.setitem(torch_config.transformer_configs, "tiny",
                   lambda **kw: torch_config.TransformerConfig(**TINY, **kw))
        yield


def configs(dtype: str = "float32"):
    """(JAX TiTokConfig, port TiTokConfig) of the tiny TiTok; call inside
    ``tiny_preset``."""
    return (JaxTiTokConfig(**TITOK, dtype=getattr(jnp, dtype)),
            TiTokConfig(**TITOK, dtype=getattr(torch, dtype)))


def jax_params(cfg_j) -> dict:
    """TiTok.init(PRNGKey(0)) params as a nested dict of numpy arrays."""
    x = jnp.zeros((1, cfg_j.image_size, cfg_j.image_size, 3))
    params = jax.jit(JaxTiTok(cfg_j).init)(jax.random.PRNGKey(0), x)["params"]
    return jax.tree.map(np.asarray, params)


def port_model(cfg_t, params: dict) -> TiTok:
    """The port's TiTok on the CPU, filled with the JAX weights."""
    model = TiTok(cfg_t, device="meta")
    model.load_state_dict(state_dict_from_flax(params, cfg_t), assign=True)
    return model.eval().requires_grad_(False)


def images(n: int, seed: int = 0, size: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (n, size, size, 3)).astype(np.float32)


def convnext_params() -> dict:
    """The tiny JAX ConvNeXt's init(PRNGKey(0)) params, numpy leaves."""
    from vit_tpu.losses.perceptual import ConvNeXt as JaxConvNeXt

    # the params do not depend on the image size; 32 keeps the init cheap
    params = jax.jit(JaxConvNeXt(**CONVNEXT).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree.map(np.asarray, params)


def jax_perceptual(params: dict, dtype=jnp.float32):
    """The JAX PerceptualLoss around the tiny ConvNeXt, built as the JAX
    package's own tests build it."""
    from vit_tpu.losses.perceptual import ConvNeXt as JaxConvNeXt
    from vit_tpu.losses.perceptual import PerceptualLoss as JaxPerceptual

    loss = JaxPerceptual.__new__(JaxPerceptual)
    loss.model = JaxConvNeXt(**CONVNEXT, dtype=dtype)
    loss.layout = "nhwc"
    loss.params = jax.tree.map(jnp.asarray, params)
    return loss


def port_perceptual(params: dict, dtype=torch.float32):
    """The port's PerceptualLoss with the same tiny ConvNeXt weights."""
    from vit_tpu_torch.losses.perceptual import PerceptualLoss

    return PerceptualLoss.from_params(params, dtype=dtype, **CONVNEXT)


def jax_train_step(model, perceptual, **opt):
    """The JAX package's jitted tokenizer step and a fresh TrainState
    factory for ``make_optimizer(**opt)``."""
    from vit_tpu.train.optim import make_optimizer
    from vit_tpu.train.state import TrainState
    from vit_tpu.train.step import make_tokenizer_train_step

    tx = make_optimizer(**opt)
    step = jax.jit(make_tokenizer_train_step(model,
                                             perceptual_loss_fn=perceptual))
    return step, lambda params: TrainState.create(params, tx)


def videogpt_configs(dtype: str = "float32", **kw):
    """(JAX VideoGPTConfig with attn_impl "pallas", port VideoGPTConfig) of
    the tiny VideoGPT: ``VIDEOGPT`` with keyword overrides, then the
    transformer cut to ``TINY``."""
    from vit_tpu.models.videogpt import VideoGPTConfig as JaxVideoGPTConfig
    from vit_tpu_torch.models.videogpt import VideoGPTConfig

    fields = {**VIDEOGPT, **kw}
    cfg_j = JaxVideoGPTConfig(**fields, dtype=getattr(jnp, dtype),
                              attn_impl="pallas")
    cfg_t = VideoGPTConfig(**fields, dtype=getattr(torch, dtype))
    for cfg in (cfg_j, cfg_t):
        cfg.trans_config = cfg.trans_config.replace(**TINY)
        cfg.n_embd = TINY["n_embd"]
    return cfg_j, cfg_t


def videogpt_params(cfg_j) -> dict:
    """VideoGPT.init(PRNGKey(1)) params as a nested dict of numpy arrays
    (one frame is enough: the params do not depend on the length)."""
    from vit_tpu.models.videogpt import VideoGPT as JaxVideoGPT

    x = jnp.zeros((1, 1, cfg_j.frame_size), jnp.int32)
    params = jax.jit(JaxVideoGPT(cfg_j).init)(jax.random.PRNGKey(1), x)["params"]
    return jax.tree.map(np.asarray, params)


def port_videogpt(cfg_t, params: dict):
    """The port's VideoGPT on the CPU, filled with the JAX weights."""
    from vit_tpu_torch.bridge import videogpt_state_dict_from_flax
    from vit_tpu_torch.models.videogpt import VideoGPT

    model = VideoGPT(cfg_t, device="meta")
    model.load_state_dict(videogpt_state_dict_from_flax(params, cfg_t),
                          assign=True)
    return model.eval()


def codes(shape, n_codes: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, n_codes, shape,
                                                dtype=np.int32)


def count_plain_calls(monkeypatch) -> dict:
    """Count the calls of the four kernels' plain versions (which the
    wrappers run on the CPU): proof that a fused path ran."""
    calls = dict.fromkeys(("ln_matmul_fwd", "ln_matmul_dgelu", "ln_bwd",
                           "fc_grad"), 0)
    routes = [(k_lnmm, "ln_matmul_fwd_ref", "ln_matmul_fwd"),
              (k_lnmm, "ln_matmul_dgelu_ref", "ln_matmul_dgelu"),
              (k_lnmm, "ln_bwd_ref", "ln_bwd"),
              (k_fc, "matmul_dw_db_ref", "fc_grad")]
    for mod, attr, key in routes:
        def spy(*args, _fn=getattr(mod, attr), _key=key, **kw):
            calls[_key] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, attr, spy)
    return calls
