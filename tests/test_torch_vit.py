"""Port parity for the ViT classifier slice: the tiny ``ViTClassifier``
(image 32, patch 8, the 2-layer × 2-head × 128 preset) against the JAX model
through the bridge, three steps of the classifier train step and the eval
step against the JAX package's, dropout from an explicit generator (the
same seed gives the same steps, eval mode draws nothing, the MLP keeps
about 1 − rate), the synthetic image stream, the ``train_vit`` entry on
the CPU, and a tiny VideoGPT step with dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY, tiny_preset, videogpt_configs
from vit_tpu.data.synthetic import SyntheticImageLoader as JaxImageLoader
from vit_tpu.models.vit import ViTClassifier as JaxViTClassifier
from vit_tpu.models.vit import ViTConfig as JaxViTConfig
from vit_tpu_torch.bridge import (classifier_state_dict_from_flax, flatten,
                                  flax_from_state_dict)
from vit_tpu_torch.data.synthetic import SyntheticImageLoader
from vit_tpu_torch.kernels import attention as k_attn
from vit_tpu_torch.models.vit import ViTClassifier, ViTConfig
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState
from vit_tpu_torch.train.step import (make_classifier_eval_step,
                                      make_classifier_train_step)

# fp32 on both sides: the BASELINE.md golden contract
GOLDEN_TOL = 1e-3
# each parameter's change over three steps against JAX's, relative to its
# size: fp32 on both sides, only reduction order differs
UPDATE_REL = 1e-2
N_CLASSES = 10
VIT = dict(image_size=32, in_channels=3, patch_size=8, transformer="tiny",
           extra_tokens=1)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, N_CLASSES, n, dtype=np.int32))


@pytest.fixture(scope="module")
def tiny_vit():
    """(JAX model, its init params as numpy, the port's fp32 config)."""
    with tiny_preset():
        cfg_j = JaxViTConfig(**VIT, dropout=0.0, dtype=jnp.float32)
        cfg_t = ViTConfig(**VIT, dropout=0.0, dtype=torch.float32)
        net_j = JaxViTClassifier(cfg_j, num_classes=N_CLASSES)
        params = jax.jit(net_j.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 32, 32, 3)))["params"]
    return net_j, jax.tree.map(np.asarray, params), cfg_t


def _port(cfg_t, params) -> ViTClassifier:
    model = ViTClassifier(cfg_t, N_CLASSES, device="meta")
    model.load_state_dict(classifier_state_dict_from_flax(params, cfg_t,
                                                          N_CLASSES),
                          assign=True)
    return model


def test_classifier_matches_jax(tiny_vit):
    """Eval-mode logits and every parameter's gradient of the CE, fp32."""
    net_j, params, cfg_t = tiny_vit
    x, y = _images(4, seed=1)

    def loss_fn(p):
        logits = net_j.apply({"params": p}, jnp.asarray(x), True)
        ce = -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                  jnp.asarray(y)[:, None], -1).mean()
        return ce, logits

    (loss_j, logits_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model = _port(cfg_t, params).eval()
    logits = model(torch.from_numpy(x))
    assert logits.shape == (4, N_CLASSES) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               atol=GOLDEN_TOL, rtol=0)
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(y).long())
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=GOLDEN_TOL)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    port = flatten(flax_from_state_dict(dict(zip(names, grads))))
    ref = flatten(jax.tree.map(np.asarray, grads_j))
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=GOLDEN_TOL, rtol=0,
                                   err_msg=k)
    # the bridge reads the {"vit": ..., "head": ...} tree and back
    back = flatten(flax_from_state_dict(model.state_dict()))
    for k, v in flatten(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_classifier_train_steps_match_jax(tiny_vit):
    """Three fp32 steps at dropout 0 against the jitted JAX step: loss,
    accuracy and the clip's gradient norm per step, then every parameter.
    Warmup 1, so steps 1 and 2 move the weights."""
    from vit_tpu.train.optim import make_optimizer as jax_make_optimizer
    from vit_tpu.train.state import TrainState as JaxTrainState
    from vit_tpu.train.step import make_classifier_train_step as jax_step_fn

    net_j, params, cfg_t = tiny_vit
    opt = dict(lr=1e-3, warmup_steps=1, train_steps=100, min_lr=1e-4,
               weight_decay=1e-2, clip_norm=1.0)
    step_j = jax.jit(jax_step_fn(net_j))
    state_j = JaxTrainState.create(jax.tree.map(jnp.asarray, params),
                                   jax_make_optimizer(**opt))
    model = _port(cfg_t, params)
    state = TrainState.create(model, make_optimizer(**opt))
    step = make_classifier_train_step(model)
    for i in range(3):
        x, y = _images(4, seed=10 + i)
        state_j, m_j = step_j(state_j, jnp.asarray(x), jnp.asarray(y),
                              jax.random.PRNGKey(0))
        _, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert set(m) == set(m_j) == {"train/loss", "train/acc",
                                      "train/grad_norm"}
        for k in m_j:
            assert m[k].dim() == 0 and m[k].dtype == torch.float32
            np.testing.assert_allclose(m[k].item(), float(m_j[k]),
                                       rtol=GOLDEN_TOL, atol=1e-6, err_msg=k)
    assert state.step.item() == 3
    port = flatten(flax_from_state_dict(model.state_dict()))
    ref = flatten(jax.tree.map(np.asarray, state_j.params))
    start = flatten(params)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=GOLDEN_TOL, rtol=0,
                                   err_msg=k)
        moved, moved_ref = port[k] - start[k], ref[k] - start[k]
        assert np.linalg.norm(moved_ref) > 0, k
        rel = np.linalg.norm(moved - moved_ref) / np.linalg.norm(moved_ref)
        assert rel <= UPDATE_REL, (k, rel)


def test_eval_step_matches_jax(tiny_vit):
    from vit_tpu.train.step import make_classifier_eval_step as jax_eval_fn

    net_j, params, cfg_t = tiny_vit
    x, y = _images(8, seed=3)
    m_j = jax.jit(jax_eval_fn(net_j))(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(x), jnp.asarray(y))
    model = _port(cfg_t, params).train()
    m = make_classifier_eval_step(model)(torch.from_numpy(x),
                                         torch.from_numpy(y))
    assert set(m) == set(m_j) == {"valid/loss", "valid/acc"}
    for k in m_j:
        np.testing.assert_allclose(m[k].item(), float(m_j[k]),
                                   rtol=GOLDEN_TOL, err_msg=k)
    assert model.training   # the step restores the model's mode


@pytest.fixture(scope="module")
def dropout_model():
    """The tiny classifier at dropout 0.15, bf16 compute as train_vit.py
    runs it, with the tiny JAX init weights."""
    with tiny_preset():
        cfg_j = JaxViTConfig(**VIT, dropout=0.15)
        cfg_t = ViTConfig(**VIT, dropout=0.15)
        params = jax.jit(JaxViTClassifier(cfg_j, num_classes=N_CLASSES).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return _port(cfg_t, jax.tree.map(np.asarray, params))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_dropout_draws_from_the_generator(dropout_model):
    """The same generator seed gives the same logits and gradients, another
    seed others; eval mode draws nothing; training without a generator
    raises."""
    model = dropout_model.train()
    x = torch.from_numpy(_images(4, seed=5)[0])

    def run(seed):
        logits = model(x, _gen(seed))
        grads = torch.autograd.grad(logits.square().sum(),
                                    list(model.parameters()))
        return logits.detach(), grads

    (a, ga), (b, gb), (c, _) = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert all(torch.equal(g, h) for g, h in zip(ga, gb))
    assert not torch.allclose(a, c, atol=1e-3)
    with pytest.raises(ValueError, match="Generator"):
        model(x)
    model.eval()
    gen = _gen(3)
    state = gen.get_state()
    with torch.no_grad():
        ev = model(x, gen)
        assert torch.equal(ev, model(x))
    assert torch.equal(gen.get_state(), state)
    assert not torch.allclose(ev, a, atol=1e-3)


def test_dropout_train_steps_repeat_under_one_seed(dropout_model):
    """Two runs of two classifier steps from the same weights and generator
    seed give the same losses; the attention's plain versions took the
    dropout branch."""
    start = {k: v.clone() for k, v in dropout_model.state_dict().items()}
    x, y = map(torch.from_numpy, _images(4, seed=6))

    def run(seed):
        dropout_model.load_state_dict(start)
        state = TrainState.create(dropout_model, make_optimizer(
            1e-3, 1, 100, 1e-4, 1e-2, clip_norm=None))
        step = make_classifier_train_step(dropout_model)
        gen = _gen(seed)
        return [step(state, x, y, gen)[1]["train/loss"].item()
                for _ in range(2)]

    first, again, other = run(7), run(7), run(8)
    assert first == again and first != other
    assert all(np.isfinite(first))
    assert k_attn.dropout_launches == k_attn.launches == 0   # the CPU path
    dropout_model.load_state_dict(start)


def test_mlp_keeps_about_one_minus_rate(dropout_model):
    """fc2's output is dropped in the compute dtype and the kept values
    divided by 1 − rate: the kept share lies within 5σ of a binomial."""
    rate = 0.15
    mlp = dropout_model.vit.transformer.layers[0].mlp
    x = torch.randn(8, 17, TINY["n_embd"], generator=_gen(0)).bfloat16()
    with torch.no_grad():
        full = mlp(x)
        out = mlp(x, dropout_rate=rate, generator=_gen(1))
    assert out.dtype == full.dtype == torch.bfloat16
    live = full != 0
    kept = (out != 0) & live
    n = int(live.sum())
    frac = kept.sum().item() / n
    assert abs(frac - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5
    np.testing.assert_array_equal(out[kept].float().numpy(),
                                  (full[kept] / (1 - rate)).float().numpy())


def test_synthetic_image_loader_matches_jax():
    """Two epochs of the noise stream, bit for bit."""
    kw = dict(num_classes=N_CLASSES, steps_per_epoch=2, seed=4)
    ref, port = JaxImageLoader(16, 3, **kw), SyntheticImageLoader(16, 3, **kw)
    assert len(port) == len(ref) == 2
    for _ in range(2):
        for (xr, yr), (xp, yp) in zip(ref, port):
            assert xp.dtype == xr.dtype and yp.dtype == yr.dtype
            np.testing.assert_array_equal(xp, xr)
            np.testing.assert_array_equal(yp, yr)


TINY_VIT_ENTRY = ["--dataset", "synthetic", "--no_wandb", "--device", "cpu",
                  "--transformer", "tiny", "--image_size", "32",
                  "--patch_size", "8", "--bs", "4", "--num_classes", "10",
                  "--steps_per_epoch", "2", "--log_every", "1",
                  "--warmup_steps", "1"]


def test_train_vit_entry_runs_on_the_cpu(capsys, tmp_path):
    from vit_tpu_torch.train_vit import main

    with tiny_preset():
        logs = main(TINY_VIT_ENTRY + ["--epochs", "1",
                                      "--ckpt_dir", str(tmp_path / "ckpt"),
                                      "--run_dir", str(tmp_path / "runs")])
    assert [r["i"] for r in logs["train"]] == [0, 1]
    assert all(np.isfinite(r["loss"]) and 0 <= r["acc"] <= 1
               for r in logs["train"])
    assert len(logs["valid"]) == 1 and np.isfinite(logs["valid"][0]["loss"])
    out = capsys.readouterr().out
    assert "e=0 i=1 loss=" in out and "epoch 0: val_loss=" in out


@pytest.mark.parametrize("flags", [
    ["--dataset", "imagenet"], ["--dataset", "wds"], ["--init_from", "ckpt"],
    ["--scan_layers", "true"], ["--mesh", "1,1,1"],
    ["--pp_microbatches", "2"], ["--loader_backend", "grain"],
    ["--loader_processes", "2"], ["--attn_impl", "xla"],
], ids=lambda f: "_".join(a.lstrip("-") for a in f))
def test_train_vit_refuses_unported_flags(flags):
    """Each flag whose path is not ported raises before anything is built,
    naming its ROADMAP item (``--mixed false`` runs:
    tests/test_torch_fp32.py)."""
    from vit_tpu_torch.train_vit import main

    base = [] if flags[:1] == ["--dataset"] else ["--dataset", "synthetic"]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A #"):
        main(base + flags)


def _vit_entry(tmp_path, name: str, epochs: int, *extra: str):
    from vit_tpu_torch.train_vit import main

    with tiny_preset():
        return main(TINY_VIT_ENTRY + [
            "--epochs", str(epochs), "--ckpt_dir", str(tmp_path / name),
            "--run_dir", str(tmp_path / "runs" / name), *extra])


@pytest.mark.parametrize("flag", ["resume", "ckpt_dir", "run_dir"])
def test_train_vit_lifted_flags(flag, tmp_path, capsys):
    """The flags the JAX entry's checkpoints and logger serve. ``resume``:
    one epoch, then ``--resume`` for the second, repeats the straight
    two-epoch run's second epoch (dropout 0.15 included: its generator is
    seeded by the step) at rtol 1e-6. ``ckpt_dir``: "best" is the epoch of
    the highest validation accuracy (mode max) and "last" the final step,
    each restorable. ``run_dir``: the JSONL log with its ``_config`` line,
    the train and valid records and the final ``_step``."""
    import json

    from vit_tpu_torch.train.checkpoint import load_params

    if flag == "resume":
        straight = _vit_entry(tmp_path, "a", 2)
        _vit_entry(tmp_path, "b", 1)
        capsys.readouterr()
        resumed = _vit_entry(tmp_path, "b", 2, "--resume")
        assert "RESUMED data stream at epoch 1, batch 0" in \
            capsys.readouterr().out
        want = [r for r in straight["train"] if r["epoch"] == 1]
        assert [r["i"] for r in resumed["train"]] == [r["i"] for r in want]
        for got, ref in zip(resumed["train"], want):
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
    elif flag == "ckpt_dir":
        logs = _vit_entry(tmp_path, "c", 2)
        accs = [r["acc"] for r in logs["valid"]]
        meta = json.loads((tmp_path / "c" / "last_meta.json").read_text())
        assert meta["step"] == 4
        if max(accs) > 0:   # "best" is saved only above accuracy 0
            best = json.loads((tmp_path / "c" / "best_meta.json").read_text())
            assert best["best"] == max(accs)
            assert best["step"] == 2 * (1 + accs.index(max(accs)))
            assert set(load_params(str(tmp_path / "c"), "best")) == \
                set(load_params(str(tmp_path / "c"), "last"))
        else:
            assert not (tmp_path / "c" / "best").exists()
        assert json.loads((tmp_path / "c" / "last_config.json").read_text()
                          )["transformer"] == "tiny"
    else:
        logs = _vit_entry(tmp_path, "d", 1)
        path = tmp_path / "runs" / "d" / "vit-classifier" / \
            "8px_32px_tiny_4bs_0.0001lr_0.15drp.jsonl"
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        assert rows[0]["_config"]["transformer"] == "tiny"
        assert rows[0]["_platform"] == "cpu"
        train = [r for r in rows if "train/loss" in r]
        assert [r["_step"] for r in train] == [1, 2]
        np.testing.assert_allclose([r["train/loss"] for r in train],
                                   [r["loss"] for r in logs["train"]])
        assert rows[-1]["valid/loss"] == logs["valid"][0]["loss"]


class _Codes:
    """A stand-in frozen tokenizer: 8 codes per frame from its pixels."""

    def encode_indices(self, frames):
        return (frames.reshape(len(frames), 8, -1).sum(-1) * 7).long() % 64


def test_videogpt_step_with_dropout():
    """The VideoGPT step at dropout 0.1 (97 frames × 8 codes: S 776, the
    unpacked kernels' plain versions with their dropout branch) repeats
    under one generator seed, differs under another, and needs one."""
    from vit_tpu_torch.models.videogpt import VideoGPT
    from vit_tpu_torch.train.step import make_videogpt_train_step
    from vit_tpu_torch.utils.init import init_params_

    _, cfg_t = videogpt_configs("float32", frame_size=8, max_frames=97,
                                dropout=0.1)
    assert cfg_t.trans_config.dropout == 0.1
    model = VideoGPT(cfg_t)
    init_params_(model, _gen(0))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    videos = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 97, 4, 4, 3)).astype(np.float32))
    step = make_videogpt_train_step(model)

    def run(seed):
        model.load_state_dict(start)
        state = TrainState.create(model, make_optimizer(
            1e-4, 1, 100, 1e-5, 1e-4, clip_norm=None))
        gen = _gen(seed)
        return [step(state, _Codes(), videos, gen)[2]["train/loss"].item()
                for _ in range(2)]

    first, again, other = run(1), run(1), run(2)
    assert first == again and first != other and all(np.isfinite(first))
    with pytest.raises(ValueError, match="Generator"):
        step(TrainState.create(model, make_optimizer(
            1e-4, 1, 100, 1e-5, 1e-4, clip_norm=None)), _Codes(), videos)
    assert k_attn.unpacked_dropout_launches == k_attn.unpacked_launches == 0
