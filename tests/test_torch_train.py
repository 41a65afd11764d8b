"""Port parity for training: the LR schedule, the recording clip and AdamW
against optax, and three steps of the tokenizer train step (tiny TiTok,
tiny ConvNeXt perceptual loss, clip, AdamW with a bf16 first moment)
against the JAX package's step in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import (TINY_FUSED_DIM, configs, convnext_params,
                                count_plain_calls, images, jax_params,
                                jax_perceptual, jax_train_step, port_model,
                                port_perceptual, tiny_preset)
from vit_tpu.models.titok import TiTok as JaxTiTok
from vit_tpu.train.optim import clip_by_global_norm_recording
from vit_tpu.train.optim import get_lr_schedule as jax_schedule
from vit_tpu.train.optim import make_optimizer as jax_make_optimizer
from vit_tpu_torch.bridge import flatten, flax_from_state_dict
from vit_tpu_torch.kernels import convnext_block as k_cnx
from vit_tpu_torch.train.optim import (clip_by_global_norm_,
                                       get_lr_schedule, make_optimizer)
from vit_tpu_torch.train.state import TrainState
from vit_tpu_torch.train.step import make_tokenizer_train_step

# fp32 on both sides: optimizer arithmetic in the same order, so only fp32
# rounding of pow/sqrt differs; the train step holds the BASELINE.md 1e-3
# golden contract.
OPT_TOL = 1e-6
STEP_TOL = 1e-3
# The parameter change over the three steps, per tensor, relative to the JAX
# change: fp32 on both sides, so only reduction order differs.
UPDATE_REL = 1e-2
SCHED = dict(lr=1e-3, warmup_steps=10, train_steps=100, min_lr=1e-5)


@pytest.mark.parametrize("step", [0, 9, 10, 99, 100])
def test_schedule_matches_jax(step):
    """0 and warmup−1 in the warmup (lr 0 at step 0), warmup the cosine's
    start, T−1 its end, T the constant tail."""
    ref = float(jax_schedule(**SCHED)(jnp.asarray(step)))
    out = get_lr_schedule(**SCHED)(torch.tensor(step))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.item(), ref, rtol=OPT_TOL, atol=0)
    if step == 0:
        assert out.item() == 0.0


def _grads(seed, shapes=((8, 6), (6,), (3, 4, 5))):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("max_norm", [100.0, 1.0])   # below and above the norm
def test_clip_matches_jax(max_norm):
    grads = _grads(1)
    clip = clip_by_global_norm_recording(max_norm)
    tree = [jnp.asarray(g) for g in grads]
    ref, state = clip.update(tree, clip.init(tree))
    tg = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(tg, max_norm)
    np.testing.assert_allclose(norm.item(), float(state.grad_norm),
                               rtol=OPT_TOL)
    for out, r, g in zip(tg, ref, grads):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), rtol=OPT_TOL,
                                   atol=1e-7)
        if max_norm == 100.0:
            np.testing.assert_array_equal(out.numpy(), g)


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adamw_steps_match_optax(mu_dtype):
    """Five steps of clip → AdamW on fixed gradients, warmup 2 (so the
    first step has lr 0), fp32 and bf16 first moments. The optax update is
    jitted, as inside the JAX train step: XLA then keeps b1·μ in fp32."""
    opt = dict(lr=1e-2, warmup_steps=2, train_steps=50, min_lr=1e-3,
               weight_decay=1e-2, clip_norm=1.0, mu_dtype=mu_dtype)
    p0 = _grads(2)
    tx = jax_make_optimizer(**opt)
    jp = [jnp.asarray(p) for p in p0]
    js = tx.init(jp)
    params = [torch.from_numpy(p.copy()) for p in p0]
    port = make_optimizer(**opt)
    state = port.init(params)
    for i in range(5):
        g = _grads(10 + i)
        updates, js = jax.jit(tx.update)([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, updates)
        # The port clips its gradients in place; on the CPU jnp.asarray may
        # share the numpy buffer, and JAX's update runs asynchronously, so
        # the port gets copies.
        port.update_(params, [torch.from_numpy(a.copy()) for a in g], state)
        for out, ref in zip(params, jp):
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       rtol=OPT_TOL, atol=OPT_TOL)
    want = torch.bfloat16 if mu_dtype else torch.float32
    assert all(m.dtype == want for m in state.mu)
    assert all(n.dtype == torch.float32 for n in state.nu)
    assert state.count.item() == 5
    adam = js[1][0]
    for m, ref in zip(state.mu, adam.mu):
        np.testing.assert_allclose(m.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=1e-2,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def tiny_setup():
    with tiny_preset():
        cfg_j, cfg_t = configs("float32")
        yield cfg_j, cfg_t, jax_params(cfg_j), convnext_params()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_train_step_matches_jax(tiny_setup, monkeypatch, fused):
    """The slice as a whole: three fp32 steps of the port's step against
    the JAX step from the same weights and batches. Warmup 1, so steps 1
    and 2 have lr > 0; the stage-3 ConvNeXt block takes the unfused path.
    ``fused`` sets VIT_TPU_FUSED_LN=1 VIT_TPU_FUSED_FC=1 on both sides (a
    fresh jitted JAX step reads them when it traces), and the fused
    kernels' plain versions must have run."""
    monkeypatch.setattr(k_cnx, "MAX_FUSED_DIM", TINY_FUSED_DIM)
    for var in ("VIT_TPU_FUSED_LN", "VIT_TPU_FUSED_FC"):
        if fused:
            monkeypatch.setenv(var, "1")
        else:
            monkeypatch.delenv(var, raising=False)
    calls = count_plain_calls(monkeypatch)
    cfg_j, cfg_t, params, cnx = tiny_setup
    opt = dict(lr=1e-4, warmup_steps=1, train_steps=1000, min_lr=1e-5,
               weight_decay=1e-4, clip_norm=1.0)
    with tiny_preset():
        net_j = JaxTiTok(cfg_j)
        model = port_model(cfg_t, params).train().requires_grad_(True)
    step_j, create = jax_train_step(net_j, jax_perceptual(cnx), **opt)
    state_j = create(jax.tree.map(jnp.asarray, params))
    usage_j = jnp.zeros((cfg_j.codebook_size,))
    state = TrainState.create(model, make_optimizer(**opt))
    usage = torch.zeros(cfg_t.codebook_size)
    step = make_tokenizer_train_step(model,
                                     perceptual_loss_fn=port_perceptual(cnx))
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
            assert m[k].dim() == 0 and m[k].dtype == torch.float32
            np.testing.assert_allclose(m[k].item(), float(m_j[k]),
                                       rtol=STEP_TOL, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j),
                                   atol=STEP_TOL, rtol=0)
        np.testing.assert_array_equal(usage.numpy(), np.asarray(usage_j))
    assert state.step.item() == 3
    assert all(calls.values()) if fused else not any(calls.values()), calls
    port = flatten(flax_from_state_dict(model.state_dict()))
    ref = flatten(jax.tree.map(np.asarray, state_j.params))
    assert port.keys() == ref.keys()
    start = flatten(params)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=STEP_TOL, rtol=0,
                                   err_msg=k)
        # Adam moves each weight by at most ~lr per step, far below the
        # absolute bound above, so the update itself is held relative to
        # its size: a step that skips it or flips its sign fails here.
        moved, moved_ref = port[k] - start[k], ref[k] - start[k]
        assert np.linalg.norm(moved_ref) > 0, k
        rel = np.linalg.norm(moved - moved_ref) / np.linalg.norm(moved_ref)
        assert rel <= UPDATE_REL, (k, rel)


@pytest.mark.parametrize("target", ["quantized", "loss"])
def test_quantizer_gradients_match_jax(target):
    """The codebook's gradient comes from the codebook loss only, the
    encoder's through the commitment loss and the straight-through
    estimator only: both against ``jax.grad`` of the JAX Quantizer."""
    from vit_tpu.quantize.vq import Quantizer as JaxQuantizer
    from vit_tpu_torch.quantize.vq import Quantizer

    rng = np.random.default_rng(7)
    z = rng.normal(size=(3, 5, 12)).astype(np.float32)
    cb = rng.normal(size=(16, 12)).astype(np.float32)
    w = rng.normal(size=(3, 5, 12)).astype(np.float32)   # a cotangent

    def f_jax(z_, cb_):
        q, _, loss = JaxQuantizer(16, 12).apply({"params": {"codebook": cb_}},
                                                z_)
        return jnp.sum(q * w) if target == "quantized" else loss

    gz_j, gcb_j = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(z),
                                                  jnp.asarray(cb))
    quant = Quantizer(16, 12)
    quant.codebook.data = torch.from_numpy(cb)
    tz = torch.from_numpy(z).requires_grad_()
    q, _, loss = quant(tz)
    out = (q * torch.from_numpy(w)).sum() if target == "quantized" else loss
    gz, gcb = torch.autograd.grad(out, (tz, quant.codebook),
                                  allow_unused=True)
    np.testing.assert_allclose(gz.numpy(), np.asarray(gz_j), atol=1e-6)
    if target == "quantized":   # the STE passes nothing to the codebook
        assert gcb is None and not np.asarray(gcb_j).any()
    else:
        np.testing.assert_allclose(gcb.numpy(), np.asarray(gcb_j), atol=1e-7)
