"""Port parity for the TiTok slice: JAX weights carried across by the bridge,
the same seeded images through both packages, fp32 (the 1e-3 golden
contract), plus a bf16 smoke run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (configs, images, jax_params, port_model,
                                tiny_preset)
from vit_tpu.core.transformer import TransformerLayer as JaxLayer
from vit_tpu.models.titok import TiTok as JaxTiTok


@pytest.fixture(scope="module")
def params():
    """JAX init params; the same for either compute dtype (params are fp32)."""
    with tiny_preset():
        yield jax_params(configs("float32")[0])


@pytest.fixture(scope="module")
def fp32(params):
    with tiny_preset():
        cfg_j, cfg_t = configs("float32")
        yield JaxTiTok(cfg_j), {"params": params}, port_model(cfg_t, params)


@pytest.mark.parametrize("gelu_env", [None, "erf"])
def test_transformer_block_matches_jax(fp32, gelu_env, monkeypatch):
    """Default tanh-erf GELU on both sides; VIT_TPU_GELU=erf is the
    strict-erf case, set for both packages."""
    if gelu_env:
        monkeypatch.setenv("VIT_TPU_GELU", gelu_env)
    net_j, variables, model = fp32
    x = np.random.default_rng(1).normal(size=(2, 24, 128)).astype(np.float32)
    layer_params = variables["params"]["enc"]["vit"]["transformer"]["layer_0"]
    tc = net_j.config.enc_vit_config.trans_config
    ref = JaxLayer(tc).apply({"params": layer_params}, jnp.asarray(x))
    out = model.enc.vit.transformer.layers[0](torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_encoder_latents_match_jax(fp32):
    net_j, variables, model = fp32
    x = images(3, seed=2)
    ref = net_j.apply(variables, jnp.asarray(x),
                      method=lambda m, x: m.enc(x))
    out = model.enc(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (3, 8, 12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_encode_decode_and_forward_match_jax(fp32):
    net_j, variables, model = fp32
    x = images(4, seed=3)
    idx_ref = np.array(net_j.apply(variables, jnp.asarray(x),
                                   method=net_j.encode))
    idx = model.encode(torch.from_numpy(x))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), idx_ref)

    dec_ref = net_j.apply(variables, jnp.asarray(idx_ref),
                          method=net_j.decode_indices)
    dec = model.decode_indices(torch.from_numpy(idx_ref))
    assert dec.shape == (4, 32, 32, 3) and dec.dtype == torch.float32
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_ref), atol=1e-3,
                               rtol=0)

    recon_ref, _, loss_ref = net_j.apply(variables, jnp.asarray(x))
    recon, _, loss = model(torch.from_numpy(x))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_ref),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(loss.item(), float(loss_ref), atol=1e-3,
                               rtol=0)


def test_bf16_smoke_against_jax(params):
    with tiny_preset():
        cfg_j, cfg_t = configs("bfloat16")
        net_j, model = JaxTiTok(cfg_j), port_model(cfg_t, params)
    x = images(8, seed=4)
    idx_ref = np.asarray(net_j.apply({"params": params}, jnp.asarray(x),
                                     method=net_j.encode))
    idx = model.encode(torch.from_numpy(x)).numpy()
    assert (idx == idx_ref).mean() >= 0.95
    recon = model.decode_indices(torch.from_numpy(idx))
    assert recon.dtype == torch.float32 and recon.shape == (8, 32, 32, 3)
    assert torch.isfinite(recon).all()
