"""The port in fp32 (``--mixed false``): every kernel wrapper takes fp32
operands (a meta tensor reaches its device gate) and still refuses fp16 and
mixed dtypes; the parameters follow the rows' dtype; a dtype spy over tiny
fp32 train steps (the TiTok step unfused, with the fused LN and FC kernels,
and with the int8 perceptual loss; the ViT classifier with dropout; the
VideoGPT step) proves that each kernel wrapper receives fp32 activations and
fp32 weights, while the TiTok and ViT steps hold the JAX steps at
``dtype=float32`` within the BASELINE.md 1e-3 contract; and
``vit_tpu_torch.train_vit`` runs with ``--mixed false``, refused nowhere."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.kernels.convnext_block as jax_cnx
import vit_tpu_torch.quantize.vq as quant_vq
from torch_port_helpers import (TINY_FUSED_DIM, configs, convnext_params,
                                images, jax_params, jax_perceptual,
                                jax_train_step, port_model, port_perceptual,
                                tiny_preset, videogpt_configs, with_gamma)
from vit_tpu.models.titok import TiTok as JaxTiTok
from vit_tpu_torch.kernels import attention as k_attn
from vit_tpu_torch.kernels import convnext_block as k_cnx
from vit_tpu_torch.kernels import fc_grad as k_fc
from vit_tpu_torch.kernels import fma_probe
from vit_tpu_torch.kernels import ln_matmul as k_lnmm
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState
from vit_tpu_torch.train.step import (make_classifier_train_step,
                                      make_tokenizer_train_step,
                                      make_videogpt_train_step)

STEP_TOL = 1e-3   # fp32 on both sides: the BASELINE.md golden contract
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
C = 96            # a ConvNeXt tail width the CUDA kernels are built for


def _t(*shape, dtype=F32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _tail(dt, dt2, quant=False, bwd=False):
    """A ConvNeXt tail wrapper on (10, C) meta rows of dt and dt2, fp32
    parameters."""
    p = dict(lns=_t(C), lnb=_t(C), w1=_t(4 * C, C), b1=_t(4 * C),
             w2=_t(C, 4 * C), gamma=_t(C))
    h, other = _t(10, C, dtype=dt), _t(10, C, dtype=dt2)
    if bwd:
        fn = k_cnx.convnext_tail_bwd_q8 if quant else k_cnx.convnext_tail_bwd
        return fn(h, other, *p.values())
    fn = k_cnx.convnext_tail_fwd_q8 if quant else k_cnx.convnext_tail_fwd
    return fn(h, other, p["lns"], p["lnb"], p["w1"], p["b1"], p["w2"],
              _t(C), p["gamma"])


def _unpacked(dt, dt2, bwd=False):
    q, k = _t(2, 2, 24, 64, dtype=dt), _t(2, 2, 24, 64, dtype=dt)
    v = _t(2, 2, 24, 64, dtype=dt2)
    if bwd:
        return k_attn.attention_bwd(q, k, q, v, _t(2, 2, 24), _t(2, 2, 24),
                                    False)
    return k_attn.attention_fwd(q, k, v, False)


# (wrapper, call on meta operands of dtypes (dt, dt2)); dt2 is the second
# activation operand's dtype where the wrapper has one
WRAPPERS = {
    "K1": lambda dt, dt2: k_attn.attention_packed_fwd(
        _t(2, 24, 384, dtype=dt), _t(384), 2, False),
    "K2": lambda dt, dt2: k_attn.attention_packed_bwd(
        _t(2, 24, 384, dtype=dt), _t(384), _t(2, 24, 128, dtype=dt2),
        _t(2, 2, 24), _t(2, 2, 24), 2, False),
    "K3": lambda dt, dt2: _tail(dt, dt2),
    "K4": lambda dt, dt2: _tail(dt, dt2, bwd=True),
    "K6": lambda dt, dt2: _unpacked(dt, dt2),
    "K7/K8": lambda dt, dt2: _unpacked(dt, dt2, bwd=True),
    "K9a": lambda dt, dt2: k_lnmm.ln_matmul_fwd(_t(10, 128, dtype=dt),
                                                _t(256, 128)),
    "K9b": lambda dt, dt2: k_lnmm.ln_matmul_dgelu(_t(10, 256, dtype=dt),
                                                  _t(10, 256, dtype=dt2)),
    "K9c": lambda dt, dt2: k_lnmm.ln_bwd(_t(10, 128, dtype=dt),
                                         _t(10, 128, dtype=dt2)),
    "K10": lambda dt, dt2: k_fc.matmul_dw_db(_t(10, 128, dtype=dt),
                                             _t(10, 256, dtype=dt2)),
    "K12a": lambda dt, dt2: _tail(dt, dt2, quant=True),
    "K12b": lambda dt, dt2: _tail(dt, dt2, quant=True, bwd=True),
    "P": lambda dt, dt2: fma_probe.fma_chains(_t(4, 128, dtype=dt), 2, 1),
}
PAIRED = ("K2", "K3", "K4", "K6", "K7/K8", "K9b", "K9c", "K10", "K12a",
          "K12b")


@pytest.mark.parametrize(
    "kernel,dtypes", [(k, d) for d in ("fp32", "fp16") for k in WRAPPERS]
    + [(k, "mixed") for k in PAIRED])
def test_wrappers_take_fp32_and_refuse_other_dtypes(kernel, dtypes):
    """fp32 operands pass the dtype check and reach the device gate (a meta
    tensor is no CUDA tensor); fp16, and fp32 beside bf16 where a wrapper
    takes two activation operands, raise TypeError before anything is
    launched."""
    call = WRAPPERS[kernel]
    if dtypes == "fp32":
        with pytest.raises(ValueError, match="unsupported device"):
            call(F32, F32)
    else:
        with pytest.raises(TypeError):
            call(*((F16, F16) if dtypes == "fp16" else (F32, BF16)))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_tail_parameters_follow_the_rows_dtype(dt):
    """The ConvNeXt tail casts its fp32 parameters to the rows' dtype, as
    the JAX package casts them to the compute dtype: fp32 rows keep fp32
    weights (no silent bf16 weights in an fp32 step)."""
    h = torch.zeros(4, C, dtype=dt)
    for p in k_cnx._weights(h, torch.ones(4 * C, C), torch.ones(C)):
        assert p.dtype == dt


# Every kernel wrapper of the port, as the model code looks it up
SPIED = [(k_attn, "attention_packed_fwd"), (k_attn, "attention_packed_bwd"),
         (k_attn, "attention_fwd"), (k_attn, "attention_bwd"),
         (k_cnx, "convnext_tail_fwd"), (k_cnx, "convnext_tail_bwd"),
         (k_cnx, "convnext_tail_fwd_q8"), (k_cnx, "convnext_tail_bwd_q8"),
         (k_lnmm, "ln_matmul_fwd"), (k_lnmm, "ln_matmul_dgelu"),
         (k_lnmm, "ln_bwd"), (k_fc, "matmul_dw_db"),
         (quant_vq, "nearest_code")]


@contextlib.contextmanager
def dtype_spy():
    """Record, per kernel wrapper, its calls, the dtypes of every floating
    tensor it is handed (activations, weights, statistics) and its calls
    with a dropout seed vector (the one int32 tensor a wrapper takes)."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in SPIED:
            def spy(*args, _fn=getattr(mod, name), _name=name, **kw):
                rec = seen.setdefault(_name, {"calls": 0, "dtypes": set(),
                                              "seeded": 0})
                tensors = [a for a in (*args, *kw.values())
                           if torch.is_tensor(a)]
                rec["calls"] += 1
                rec["dtypes"] |= {a.dtype for a in tensors
                                  if a.is_floating_point()}
                rec["seeded"] += any(a.dtype == torch.int32 for a in tensors)
                return _fn(*args, **kw)
            mp.setattr(mod, name, spy)
        yield seen


def _all_fp32(seen: dict, expect: set) -> None:
    assert set(seen) == expect, sorted(seen)
    for name, rec in seen.items():
        assert rec["calls"] > 0 and rec["dtypes"] == {F32}, (name, rec)


TITOK_SETTINGS = {
    # setting: (fused switches, int8 perceptual loss, the wrappers it runs)
    "unfused": (False, False, {"attention_packed_fwd", "attention_packed_bwd",
                               "convnext_tail_fwd", "convnext_tail_bwd",
                               "nearest_code"}),
    "fused": (True, False, {"attention_packed_fwd", "attention_packed_bwd",
                            "convnext_tail_fwd", "convnext_tail_bwd",
                            "nearest_code", "ln_matmul_fwd",
                            "ln_matmul_dgelu", "ln_bwd", "matmul_dw_db"}),
    "int8": (False, True, {"attention_packed_fwd", "attention_packed_bwd",
                           "convnext_tail_fwd_q8", "convnext_tail_bwd_q8",
                           "nearest_code"}),
}


@pytest.mark.parametrize("setting", list(TITOK_SETTINGS))
def test_titok_step_runs_fp32_kernels_and_matches_jax(setting, monkeypatch):
    """One fp32 step of the tokenizer train step (tiny TiTok, tiny ConvNeXt
    perceptual loss with γ around 0.5, its last stage unfused as
    ConvNeXt-S's) under the setting's switches, both packages: every kernel
    wrapper the setting runs sees fp32 operands only, and the step's
    metrics hold the jitted JAX step's within 1e-3."""
    fused, int8, expect = TITOK_SETTINGS[setting]
    monkeypatch.setattr(k_cnx, "MAX_FUSED_DIM", TINY_FUSED_DIM)
    monkeypatch.setattr(jax_cnx, "MAX_FUSED_DIM", TINY_FUSED_DIM)
    for var in ("VIT_TPU_FUSED_LN", "VIT_TPU_FUSED_FC"):
        if fused:
            monkeypatch.setenv(var, "1")
        else:
            monkeypatch.delenv(var, raising=False)
    cnx = with_gamma(convnext_params())
    quant = dict(quant="int8") if int8 else {}
    opt = dict(lr=1e-4, warmup_steps=1, train_steps=1000, min_lr=1e-5,
               weight_decay=1e-4, clip_norm=1.0)
    with tiny_preset():
        cfg_j, cfg_t = configs("float32")
        params = jax_params(cfg_j)
        net_j = JaxTiTok(cfg_j)
        model = port_model(cfg_t, params).train().requires_grad_(True)
    # the JAX int8 tail is its fused Pallas form; without int8 its unfused
    # tail computes the same function and compiles faster
    jax_kw = dict(mlp_impl="fused", quant="int8") if int8 else {}
    step_j, create = jax_train_step(net_j, jax_perceptual(cnx, **jax_kw),
                                    **opt)
    state = TrainState.create(model, make_optimizer(**opt))
    step = make_tokenizer_train_step(
        model, perceptual_loss_fn=port_perceptual(cnx, **quant))
    x = images(4, seed=50)
    _, _, m_j, _ = step_j(create(jax.tree.map(jnp.asarray, params)),
                          jnp.asarray(x), jnp.zeros((cfg_j.codebook_size,)),
                          jax.random.PRNGKey(0))
    with dtype_spy() as seen:
        _, _, m, _ = step(state, torch.from_numpy(x),
                          torch.zeros(cfg_t.codebook_size))
    _all_fp32(seen, expect)
    assert set(m) == set(m_j)
    for k in m_j:
        assert m[k].dtype == F32
        np.testing.assert_allclose(m[k].item(), float(m_j[k]), rtol=STEP_TOL,
                                   atol=1e-6, err_msg=k)


VIT = dict(image_size=32, in_channels=3, patch_size=8, transformer="tiny",
           extra_tokens=1)


def _vit_batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, 4, dtype=np.int32))


def test_vit_steps_run_fp32_kernels_and_match_jax():
    """The tiny ViT classifier in fp32: at dropout 0 one train step's
    metrics hold the jitted JAX step's within 1e-3; at dropout 0.15 a step
    hands K1 and K2 fp32 operands and a seed on every call (their dropout
    branch)."""
    from vit_tpu.models.vit import ViTClassifier as JaxViTClassifier
    from vit_tpu.models.vit import ViTConfig as JaxViTConfig
    from vit_tpu.train.optim import make_optimizer as jax_make_optimizer
    from vit_tpu.train.state import TrainState as JaxTrainState
    from vit_tpu.train.step import make_classifier_train_step as jax_step_fn
    from vit_tpu_torch.bridge import classifier_state_dict_from_flax
    from vit_tpu_torch.models.vit import ViTClassifier, ViTConfig

    opt = dict(lr=1e-3, warmup_steps=1, train_steps=100, min_lr=1e-4,
               weight_decay=1e-2, clip_norm=1.0)
    x, y = _vit_batch(60)
    with tiny_preset():
        net_j = JaxViTClassifier(JaxViTConfig(**VIT, dropout=0.0,
                                              dtype=jnp.float32),
                                 num_classes=10)
        params = jax.tree.map(np.asarray, jax.jit(net_j.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
        models = {}
        for rate in (0.0, 0.15):
            cfg_t = ViTConfig(**VIT, dropout=rate, dtype=F32)
            model = ViTClassifier(cfg_t, 10, device="meta")
            model.load_state_dict(classifier_state_dict_from_flax(
                params, cfg_t, 10), assign=True)
            models[rate] = model
    state_j = JaxTrainState.create(jax.tree.map(jnp.asarray, params),
                                   jax_make_optimizer(**opt))
    _, m_j = jax.jit(jax_step_fn(net_j))(state_j, jnp.asarray(x),
                                         jnp.asarray(y), jax.random.PRNGKey(0))
    expect = {"attention_packed_fwd", "attention_packed_bwd"}
    for rate, model in models.items():
        state = TrainState.create(model, make_optimizer(**opt))
        gen = torch.Generator().manual_seed(0)
        with dtype_spy() as seen:
            _, m = make_classifier_train_step(model)(
                state, torch.from_numpy(x), torch.from_numpy(y), gen)
        _all_fp32(seen, expect)
        assert all(np.isfinite(v.item()) for v in m.values())
        if rate:
            assert all(seen[k]["seeded"] == seen[k]["calls"] for k in expect)
        else:
            assert not any(seen[k]["seeded"] for k in expect)
            for k in m_j:
                np.testing.assert_allclose(m[k].item(), float(m_j[k]),
                                           rtol=STEP_TOL, atol=1e-6,
                                           err_msg=k)


class _Codes:
    """A stand-in frozen tokenizer: 8 codes per frame from its pixels."""

    def encode_indices(self, frames):
        return (frames.reshape(len(frames), 8, -1).sum(-1) * 7).long() % 64


def test_videogpt_step_runs_fp32_kernels():
    """The tiny VideoGPT step in fp32 at S 776 (97 frames × 8 codes, the
    unpacked path) with dropout 0.1: K6 and K7/K8 see fp32 operands and a
    seed on every call, and the loss is finite. (The fp32 step against the
    JAX step: tests/test_torch_videogpt.py.)"""
    from vit_tpu_torch.models.videogpt import VideoGPT
    from vit_tpu_torch.utils.init import init_params_

    _, cfg_t = videogpt_configs("float32", frame_size=8, max_frames=97,
                                dropout=0.1)
    model = VideoGPT(cfg_t)
    init_params_(model, torch.Generator().manual_seed(0))
    videos = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, 97, 4, 4, 3)).astype(np.float32))
    state = TrainState.create(model, make_optimizer(1e-4, 1, 100, 1e-5, 1e-4,
                                                    clip_norm=None))
    with dtype_spy() as seen:
        _, _, m = make_videogpt_train_step(model)(
            state, _Codes(), videos, torch.Generator().manual_seed(2))
    _all_fp32(seen, {"attention_fwd", "attention_bwd"})
    assert all(seen[k]["seeded"] == seen[k]["calls"] for k in seen)
    assert np.isfinite(m["train/loss"].item())


def test_train_vit_runs_with_mixed_false(capsys):
    """``--mixed false`` on the CPU trains in fp32 through the plain
    versions, and on the default CUDA device it is no longer refused."""
    from vit_tpu_torch.train_vit import check_ported, main, parse_args

    check_ported(parse_args(["--dataset", "synthetic", "--mixed", "false"]))
    with tiny_preset():
        logs = main(["--dataset", "synthetic", "--no_wandb", "--mixed",
                     "false", "--device", "cpu", "--transformer", "tiny",
                     "--image_size", "32", "--patch_size", "8", "--bs", "4",
                     "--num_classes", "10", "--epochs", "1",
                     "--steps_per_epoch", "2", "--log_every", "1",
                     "--warmup_steps", "1"])
    assert [r["i"] for r in logs["train"]] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in logs["train"])
    assert np.isfinite(logs["valid"][0]["loss"])
    assert "e=0 i=1 loss=" in capsys.readouterr().out
