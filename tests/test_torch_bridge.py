"""The param bridge between the JAX TiTok tree and the port's state dict, and
the ``weights.npz`` layout both exports share."""

import numpy as np
import pytest

from torch_port_helpers import configs, jax_params, tiny_preset
from vit_tpu.serve.export import _write_artifacts
from vit_tpu_torch.bridge import (flatten, flax_from_state_dict,
                                  state_dict_from_flax, unflatten)
from vit_tpu_torch.models.titok import TiTok


@pytest.fixture(scope="module")
def tiny():
    with tiny_preset():
        cfg_j, cfg_t = configs("float32")
        yield cfg_t, jax_params(cfg_j)


def test_every_leaf_consumed_and_every_param_filled(tiny):
    cfg, params = tiny
    sd = state_dict_from_flax(params, cfg)
    expected = TiTok(cfg, device="meta").state_dict()
    assert set(sd) == set(expected)
    assert len(sd) == len(flatten(params))
    for k, t in sd.items():
        assert tuple(t.shape) == tuple(expected[k].shape), k


def test_dense_kernels_are_transposed(tiny):
    cfg, params = tiny
    sd = state_dict_from_flax(params, cfg)
    qkv = params["enc"]["vit"]["transformer"]["layer_1"]["attn"]["qkv"]
    np.testing.assert_array_equal(
        sd["enc.vit.transformer.layers.1.attn.qkv.weight"].numpy(),
        qkv["kernel"].T)
    np.testing.assert_array_equal(
        sd["enc.vit.transformer.layers.1.attn.qkv.bias"].numpy(), qkv["bias"])
    np.testing.assert_array_equal(sd["dec.embd_proj.weight"].numpy(),
                                  params["dec"]["embd_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["quant.codebook"].numpy(),
                                  params["quant"]["codebook"])
    np.testing.assert_array_equal(sd["dec.vit.pos_emb"].numpy(),
                                  params["dec"]["vit"]["pos_emb"])
    assert sd["dec.vit.pos_emb"].shape == (cfg.latent_tokens, cfg.n_embd)


def test_missing_extra_or_misshapen_leaf_raises(tiny):
    cfg, params = tiny
    flat = flatten(params)
    missing = dict(flat)
    del missing["enc/proj/bias"]
    with pytest.raises(KeyError, match="no JAX leaf"):
        state_dict_from_flax(unflatten(missing), cfg)
    extra = dict(flat, **{"enc/vit/cls_token": np.zeros((1, 128))})
    with pytest.raises(KeyError, match="no port parameter"):
        state_dict_from_flax(unflatten(extra), cfg)
    bad = dict(flat, **{"enc/proj/kernel": np.zeros((12, 128))})
    with pytest.raises(ValueError, match="does not fit"):
        state_dict_from_flax(unflatten(bad), cfg)


def test_weights_npz_round_trip_matches_jax_layout(tiny, tmp_path):
    cfg, params = tiny
    # the JAX export writes its weights.npz with no executables at all here
    _write_artifacts(str(tmp_path / "jax"), {}, params, {})
    with np.load(tmp_path / "jax" / "weights.npz") as npz:
        jax_flat = {k: npz[k] for k in npz.files}
    back = flatten(flax_from_state_dict(state_dict_from_flax(
        unflatten(jax_flat), cfg)))
    assert set(back) == set(jax_flat)
    for k in jax_flat:
        np.testing.assert_array_equal(back[k], jax_flat[k])
    np.savez(tmp_path / "port.npz", **back)
    with np.load(tmp_path / "port.npz") as npz:
        tree = unflatten({k: npz[k] for k in npz.files})
    assert flatten(tree).keys() == flatten(params).keys()
