"""Port parity for the perceptual loss: the fused ConvNeXt block tail's
plain versions (K3/K4) against the Pallas kernel and its VJP in interpret
mode, the antialiased resize, a tiny ConvNeXt's logits, the perceptual loss
and its image gradient against the JAX package, and the bridge and inits
for the ConvNeXt tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (CONVNEXT, TINY_FUSED_DIM, convnext_params,
                                jax_perceptual, port_perceptual, scaled_err,
                                tail_inputs)
from vit_tpu.kernels.convnext_block import \
    frozen_convnext_block_tail as jax_tail
from vit_tpu.losses.resize import resize_bilinear_antialias as jax_resize
from vit_tpu_torch.bridge import (convnext_state_dict_from_flax, flatten,
                                  flax_from_state_dict, unflatten)
from vit_tpu_torch.kernels import convnext_block as k_cnx
from vit_tpu_torch.losses.perceptual import ConvNeXt, PerceptualLoss
from vit_tpu_torch.losses.resize import resize_bilinear_antialias
from vit_tpu_torch.utils.init import init_convnext_

# fp32: the same math summed in another order (the JAX fused-tail tests hold
# the kernel to its unfused oracle at 2e-5 of the output's scale). bf16: the
# rounding points are the same, but an fp32 value an ulp apart rounds one
# bf16 ulp (2^-8) the other way, and that travels through the next product.
TAIL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# fp32 through a whole (tiny) ConvNeXt: the BASELINE.md golden contract
GOLDEN_TOL = 1e-3


@pytest.fixture(scope="module")
def params():
    return convnext_params()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# 13: a ragged tile; C 96 and 384 are widths the CUDA kernels are built
# for, each at a ragged N
@pytest.mark.parametrize("n,c", [(40, 32), (13, 64), (77, 96), (29, 384)])
def test_block_tail_matches_jax(n, c, dtype):
    v = tail_inputs(n, c, seed=n + c)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jp = {k: jnp.asarray(a) for k, a in v.items()}
    names = ("lns", "lnb", "w1", "b1", "w2", "b2", "gamma")
    y_j, vjp = jax.vjp(lambda h, x: jax_tail(h, x, *(jp[k] for k in names)),
                       jp["h"].astype(jdt), jp["x"].astype(jdt))
    dh_j, dx_j = vjp(jp["dy"].astype(jdt))

    tp = {k: torch.from_numpy(a) for k, a in v.items()}
    tp["w1"], tp["w2"] = tp["w1"].T, tp["w2"].T   # PyTorch's Linear layout
    h = tp["h"].to(tdt).requires_grad_()
    x = tp["x"].to(tdt).requires_grad_()
    y = k_cnx.frozen_convnext_block_tail(h, x, *(tp[k] for k in names))
    dh, dx = torch.autograd.grad(y, (h, x), tp["dy"].to(tdt))
    assert y.dtype == dh.dtype == tdt
    tol = TAIL_TOL[dtype]
    assert scaled_err(y.detach().float(), y_j) < tol
    assert scaled_err(dh.float(), dh_j) < tol
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(dx_j, np.float32))


def test_block_tail_params_get_no_gradient():
    """The frozen-weight contract: the Function returns None for the seven
    parameters and refuses parameters that require grad."""
    v = tail_inputs(24, 16, seed=3)
    tp = {k: torch.from_numpy(a) for k, a in v.items()}
    tp["w1"], tp["w2"] = tp["w1"].T.contiguous(), tp["w2"].T.contiguous()
    names = ("lns", "lnb", "w1", "b1", "w2", "b2", "gamma")
    h = tp["h"].requires_grad_()
    y = k_cnx.frozen_convnext_block_tail(h, tp["x"], *(tp[k] for k in names))
    y.sum().backward()
    assert h.grad is not None
    assert all(tp[k].grad is None for k in names)
    tp["gamma"].requires_grad_()
    with pytest.raises(ValueError, match="frozen"):
        k_cnx.frozen_convnext_block_tail(h, tp["x"], *(tp[k] for k in names))


@pytest.mark.parametrize("size", [(48, 64), (128, 128)])
def test_resize_matches_jax(size):
    img = np.random.default_rng(4).uniform(
        0, 1, (2, *size, 3)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(img), 224, 224))
    out = resize_bilinear_antialias(torch.from_numpy(img), 224, 224)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    half = resize_bilinear_antialias(torch.from_numpy(img).bfloat16(), 32, 32)
    assert half.dtype == torch.bfloat16 and half.shape == (2, 32, 32, 3)


@pytest.mark.parametrize("fused_dim", [TINY_FUSED_DIM, 0])
def test_convnext_logits_match_jax(params, fused_dim, monkeypatch):
    """With the gate at 64 the fused tail runs up to C 64 and the last stage
    unfused; at 0 every block runs unfused."""
    monkeypatch.setattr(k_cnx, "MAX_FUSED_DIM", fused_dim)
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jax_perceptual(params).model.apply)({"params": params},
                                                      jnp.asarray(x))
    net = port_perceptual(params).net
    out = net(torch.from_numpy(x))
    assert out.shape == (2, CONVNEXT["num_classes"])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=GOLDEN_TOL, rtol=GOLDEN_TOL)


@pytest.mark.parametrize("fused_dim", [TINY_FUSED_DIM, 0])
def test_perceptual_loss_and_image_gradient_match_jax(params, fused_dim,
                                                      monkeypatch):
    monkeypatch.setattr(k_cnx, "MAX_FUSED_DIM", fused_dim)
    rng = np.random.default_rng(6)
    x, y = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    loss_j = jax_perceptual(params)
    ref, g_ref = jax.jit(jax.value_and_grad(loss_j))(jnp.asarray(x),
                                                      jnp.asarray(y))
    loss_t = port_perceptual(params)
    tx = torch.from_numpy(x).requires_grad_()
    out = loss_t(tx, torch.from_numpy(y))
    (g,) = torch.autograd.grad(out, tx)
    np.testing.assert_allclose(out.item(), float(ref), rtol=GOLDEN_TOL)
    assert scaled_err(g.numpy(), g_ref) < GOLDEN_TOL
    assert loss_t(tx, tx.detach()).item() == 0.0
    assert not any(p.requires_grad for p in loss_t.parameters())


def test_bridge_round_trips_the_convnext_tree(params, tmp_path):
    """The JAX package's ``.npz`` layout → load_params → the port's state
    dict → back to the same flax leaves."""
    np.savez(tmp_path / "convnext.npz", **flatten(params))
    loaded = PerceptualLoss.load_params(str(tmp_path / "convnext.npz"))
    net = ConvNeXt(**CONVNEXT)
    sd = convnext_state_dict_from_flax(loaded, net)
    assert set(sd) == set(net.state_dict())
    blk = params["stage1_block0"]
    np.testing.assert_array_equal(sd["stage1_block0.dwconv.weight"].numpy(),
                                  blk["dwconv"]["kernel"].transpose(3, 2, 0, 1))
    assert sd["stage1_block0.dwconv.weight"].shape == (32, 1, 7, 7)
    assert sd["stem_conv.weight"].shape == (16, 3, 4, 4)
    np.testing.assert_array_equal(sd["stage1_block0.pwconv1.weight"].numpy(),
                                  blk["pwconv1"]["kernel"].T)
    np.testing.assert_array_equal(sd["stage1_block0.norm.weight"].numpy(),
                                  blk["norm"]["scale"])
    back = flatten(flax_from_state_dict(sd))
    flat = flatten(params)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_bridge_raises_on_a_missing_or_extra_convnext_leaf(params):
    net = ConvNeXt(**CONVNEXT)
    flat = flatten(params)
    missing = dict(flat)
    del missing["stage2_block0/gamma"]
    with pytest.raises(KeyError, match="no JAX leaf"):
        convnext_state_dict_from_flax(unflatten(missing), net)
    extra = dict(flat, **{"stage2_block0/layer_scale": np.zeros(64)})
    with pytest.raises(KeyError, match="no port parameter"):
        convnext_state_dict_from_flax(unflatten(extra), net)


def test_convnext_init_follows_the_flax_initialisers():
    net = ConvNeXt(**CONVNEXT)
    init_convnext_(net, torch.Generator().manual_seed(0))
    w = net.stage0_block0.pwconv1.weight   # fan_in 16
    assert abs(w.std().item() * 16 ** 0.5 - 1.0) < 0.1
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / 4.0 + 1e-6
    dw = net.stage3_block0.dwconv.weight   # fan_in 49
    assert abs(dw.std().item() * 7.0 - 1.0) < 0.1
    assert torch.all(net.stage3_block0.gamma == 1e-6)
    assert torch.all(net.head_norm.weight == 1.0)
    assert torch.all(net.stem_conv.bias == 0.0)
