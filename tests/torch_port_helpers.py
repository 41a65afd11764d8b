"""Shared set-up for the ``test_torch_*`` parity tests: a tiny transformer
preset registered in both packages, the matching TiTok configs, a tiny
ConvNeXt perceptual net, JAX weights carried into the port through the
bridge, the JAX train step, and seeded numpy inputs."""

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
from vit_tpu_torch.models.titok import TiTok, TiTokConfig

# 2 layers, 2 heads, width 128: head_dim 64, so the packed kernel path applies
TINY = dict(n_layers=2, n_heads=2, n_embd=128)
# image 32, patch 8 (16 patches), K 8: S = 24 in both encoder and decoder
TITOK = dict(image_size=32, patch_size=8, latent_tokens=8, codebook_size=64,
             latent_dim=12, transformer="tiny")
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
