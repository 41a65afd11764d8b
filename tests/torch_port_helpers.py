"""Shared set-up for the ``test_torch_*`` parity tests: a tiny transformer
preset registered in both packages, the matching TiTok configs, JAX weights
carried into the port through the bridge, and seeded numpy inputs."""

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
    params = JaxTiTok(cfg_j).init(jax.random.PRNGKey(0), x)["params"]
    return jax.tree.map(np.asarray, params)


def port_model(cfg_t, params: dict) -> TiTok:
    """The port's TiTok on the CPU, filled with the JAX weights."""
    model = TiTok(cfg_t, device="meta")
    model.load_state_dict(state_dict_from_flax(params, cfg_t), assign=True)
    return model.eval().requires_grad_(False)


def images(n: int, seed: int = 0, size: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (n, size, size, 3)).astype(np.float32)
