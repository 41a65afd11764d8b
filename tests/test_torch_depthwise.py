"""Port parity for the 7×7 depthwise convolution (K11a/K11b): the plain
versions against the Pallas ``depthwise_conv`` and its VJP in interpret
mode (also at narrow ConvNeXt-S-like stage shapes), the dx-only backward
against the full one, the autograd Function's gradient routing (dx-only
for frozen taps), the wrappers' refusals off the CPU, and ``dw_impl`` on
the port's ConvNeXt block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import scaled_err
from vit_tpu.kernels.depthwise import depthwise_conv as jax_depthwise
from vit_tpu_torch.kernels import depthwise as k_dw
from vit_tpu_torch.losses.perceptual import ConvNeXtBlock

# fp32: the same fp32 sums as the Pallas kernel (bias first, the taps
# di-major), so only contraction into fused multiply-adds may differ: y and
# dx within 2e-5 of max |JAX|; dw and db are sums over every pixel of the
# batch, taken per image by the Pallas kernel and at once here: 1e-4.
Y_TOL, DW_TOL = 2e-5, 1e-4

# the shapes of tests/test_depthwise.py (k 7 and k 3), a C-128 case, and
# narrow forms of ConvNeXt-S's last two stages (14 × 14 and 7 × 7 images,
# C not a multiple of the kernels' 32-channel groups)
SHAPES = [((2, 12, 16, 8), 7), ((3, 9, 9, 16), 3), ((2, 8, 10, 8), 7),
          ((2, 7, 7, 128), 7), ((1, 14, 14, 40), 7), ((1, 7, 7, 48), 7)]


def _inputs(shape, ksize, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            (rng.normal(size=(ksize, ksize, c)) / ksize).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _beyond_one_ulp(out, ref) -> int:
    """Elements of bf16 ``out`` more than one bf16 ulp (of the larger of the
    two values) from ``ref``."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    mag = np.maximum(np.abs(out), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return int((np.abs(out - ref) > ulp).sum())


@pytest.mark.parametrize("shape,ksize", SHAPES)
def test_depthwise_matches_jax_fp32(shape, ksize):
    x, w, b, g = _inputs(shape, ksize, seed=sum(shape) + ksize)
    y_j, vjp = jax.vjp(lambda x_, w_, b_: jax_depthwise(x_, w_, b_, ksize),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dx_j, dw_j, db_j = vjp(jnp.asarray(g))

    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = k_dw.depthwise_conv(tx, tw, tb, ksize)
    dx, dw, db = torch.autograd.grad(y, (tx, tw, tb), torch.from_numpy(g))
    assert y.dtype == dx.dtype == dw.dtype == db.dtype == torch.float32
    assert scaled_err(y.detach(), y_j) < Y_TOL
    assert scaled_err(dx, dx_j) < Y_TOL
    assert scaled_err(dw, dw_j) < DW_TOL
    assert scaled_err(db, db_j) < DW_TOL


def test_depthwise_matches_jax_bf16():
    """bf16 x, w and b, fp32 accumulation, one rounding: y within one bf16
    ulp of the Pallas kernel's, and dx, dw, db too after their one rounding;
    the lax path, which rounds the conv before it adds the bias, differs."""
    shape, ksize = (2, 14, 14, 32), 7
    x, w, b, g = _inputs(shape, ksize, seed=7)
    b = b * 20.0
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)]
    y_j, vjp = jax.vjp(lambda x_, w_, b_: jax_depthwise(x_, w_, b_, ksize),
                       *jb)
    dx_j, dw_j, db_j = vjp(jnp.asarray(g, jnp.bfloat16))

    tx, tw, tb = (torch.from_numpy(a).bfloat16().requires_grad_()
                  for a in (x, w, b))
    y = k_dw.depthwise_conv(tx, tw, tb, ksize)
    dx, dw, db = torch.autograd.grad(y, (tx, tw, tb),
                                     torch.from_numpy(g).bfloat16())
    assert y.dtype == dx.dtype == dw.dtype == db.dtype == torch.bfloat16
    assert _beyond_one_ulp(y.detach().float(), y_j) == 0
    assert _beyond_one_ulp(dx.float(), dx_j) == 0
    assert _beyond_one_ulp(dw.float(), dw_j) == 0
    assert _beyond_one_ulp(db.float(), db_j) == 0
    xb, wb, bb = (t.detach() for t in (tx, tw, tb))
    lax = torch.nn.functional.conv2d(
        xb.permute(0, 3, 1, 2), wb.permute(2, 0, 1)[:, None], None, 1, 3, 1,
        shape[-1]).permute(0, 2, 3, 1) + bb
    assert not torch.equal(y.detach(), lax)


def test_backward_hands_on_only_what_is_asked():
    x, w, b, g = (torch.from_numpy(a) for a in _inputs((1, 9, 9, 8), 7, 3))
    tx = x.requires_grad_()
    y = k_dw.depthwise_conv(tx, w, b, 7)
    y.backward(g)
    assert tx.grad is not None and w.grad is None and b.grad is None
    dx, dw, db = k_dw.depthwise_bwd_ref(x.detach(), g, w)
    np.testing.assert_array_equal(tx.grad.numpy(), dx.numpy())
    assert dw.shape == (7, 7, 8) and db.shape == (8,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 12, 16, 8), (1, 14, 14, 40),
                                   (3, 7, 7, 48)])
def test_dx_only_equals_the_full_forms_dx(shape, dtype):
    """The dx-only plain backward returns the full one's dx, bit for bit,
    and no dw or db."""
    x, w, _, g = (torch.from_numpy(a).to(dtype)
                  for a in _inputs(shape, 7, seed=sum(shape)))
    dx, dw, db = k_dw.depthwise_bwd_ref(x, g, w)
    only = k_dw.depthwise_bwd_ref(x, g, w, dx_only=True)
    assert only[1] is None and only[2] is None
    assert only[0].dtype == dtype and torch.equal(only[0], dx)
    assert dw.shape == (7, 7, shape[-1]) and db.shape == (shape[-1],)
    assert torch.equal(k_dw.depthwise_bwd(x, g, w, dx_only=True)[0], dx)


@pytest.mark.parametrize("w_grad,b_grad", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_autograd_routes_frozen_taps_to_dx_only(w_grad, b_grad, monkeypatch):
    """DepthwiseConv's backward asks K11b for dx alone when neither the
    taps nor the bias need a gradient, else for the full form; each
    gradient asked for equals the plain backward's."""
    seen = []

    def spy(x, g, w, ksize=7, dx_only=False, _fn=k_dw.depthwise_bwd):
        seen.append(dx_only)
        return _fn(x, g, w, ksize, dx_only=dx_only)

    monkeypatch.setattr(k_dw, "depthwise_bwd", spy)
    x, w, b, g = (torch.from_numpy(a) for a in _inputs((2, 9, 9, 16), 7, 5))
    tx = x.clone().requires_grad_()
    tw, tb = w.clone().requires_grad_(w_grad), b.clone().requires_grad_(b_grad)
    k_dw.depthwise_conv(tx, tw, tb, 7).backward(g)
    assert seen == [not (w_grad or b_grad)]
    dx, dw, db = k_dw.depthwise_bwd_ref(x, g, w)
    assert torch.equal(tx.grad, dx)
    assert (tw.grad is not None) == w_grad and (tb.grad is not None) == b_grad
    if w_grad:
        assert torch.equal(tw.grad, dw)
    if b_grad:
        assert torch.equal(tb.grad, db)


@pytest.mark.parametrize("frozen", [True, False])
def test_frozen_block_takes_the_dx_only_backward(frozen, monkeypatch):
    """A ConvNeXt block under ``dw_impl="pallas"``: frozen, as the
    perceptual loss's trunk (``requires_grad_(False)``), its input gradient
    comes from the dx-only K11b; with trainable depthwise taps (the fused
    tail takes frozen parameters only), from the full form."""
    seen = []

    def spy(x, g, w, ksize=7, dx_only=False, _fn=k_dw.depthwise_bwd):
        seen.append(dx_only)
        return _fn(x, g, w, ksize, dx_only=dx_only)

    monkeypatch.setattr(k_dw, "depthwise_bwd", spy)
    torch.manual_seed(0)
    block = ConvNeXtBlock(16, torch.float32, dw_impl="pallas")
    block.requires_grad_(False)
    block.dwconv.requires_grad_(not frozen)
    x = torch.randn(2, 9, 9, 16, requires_grad=True)
    block(x).square().sum().backward()
    assert seen == [frozen] and x.grad is not None
    assert (block.dwconv.weight.grad is None) == frozen


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor off the CPU launches the kernel or raises; on a meta tensor
    (no card here) they raise before any launch."""
    x = torch.empty(2, 8, 8, 16, device="meta")
    w = torch.empty(7, 7, 16, device="meta")
    b = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k_dw.depthwise_fwd(x, w, b)
    with pytest.raises(ValueError, match="unsupported device"):
        k_dw.depthwise_bwd(x, x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        k_dw.depthwise_bwd(x, x, w, dx_only=True)
    with pytest.raises(ValueError, match=r"\(k, k, 16\)"):
        k_dw.depthwise_fwd(torch.zeros(2, 8, 8, 16), torch.zeros(7, 7, 8),
                           torch.zeros(16))
    assert k_dw.launches == 0 and k_dw.bwd_launches == 0
    assert k_dw.dx_only_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_dw_impl_pallas_equals_the_plain_version(dtype):
    """``dw_impl="pallas"`` routes the block's depthwise conv through
    K11a/K11b with the (7, 7, C) taps and bias of the same parameters; the
    ``lax`` block differs only by where the bias is added."""
    torch.manual_seed(0)
    lax, pallas = (ConvNeXtBlock(16, dtype, dw_impl=impl)
                   for impl in ("lax", "pallas"))
    with torch.no_grad():
        lax.dwconv.weight.normal_(0.0, 1.0 / 7)
        lax.dwconv.bias.normal_()
    pallas.load_state_dict(lax.state_dict())
    x = torch.randn(2, 9, 9, 16)
    dw = pallas.dwconv
    ref = k_dw.depthwise_fwd_ref(x.to(dtype),
                                 dw.weight[:, 0].permute(1, 2, 0).to(dtype),
                                 dw.bias.to(dtype))
    assert torch.equal(pallas._depthwise(x), ref)
    if dtype == torch.float32:
        torch.testing.assert_close(lax._depthwise(x), ref, atol=1e-5,
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="dw_impl"):
        ConvNeXtBlock(16, dtype, dw_impl="hwnc")
