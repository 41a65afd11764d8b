"""Port parity for Puzzle pretraining (``vit_tpu_torch/models/puzzle.py``,
``train/step.py``'s Puzzle steps, ``python -m vit_tpu_torch.train_puzzle``
and ``train_vit --init_from`` a Puzzle checkpoint): the "tiny" preset (2
layers × 2 heads × 64) at image 32, patch 8, against the JAX package,
fp32, from JAX init weights carried over with the bridge and JAX's own
mask noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_noise, moved_params as _moved
from torch_port_helpers import tiny_preset
from vit_tpu.models import puzzle as jax_puzzle
from vit_tpu_torch.bridge import (flatten, flax_from_state_dict,
                                  puzzle_state_dict_from_flax)
from vit_tpu_torch.models import puzzle
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState
from vit_tpu_torch.train.step import (make_puzzle_eval_step,
                                      make_puzzle_train_step)

GOLDEN_TOL = 1e-3
UPDATE_REL = 1e-2
CFG = dict(image_size=32, patch_size=8, transformer="tiny")


def _images(n, seed):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (n, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny_puzzle():
    with tiny_preset():
        cfg_j = jax_puzzle.PuzzleConfig(**CFG, dtype=jnp.float32,
                                        attn_impl="xla")
        cfg_t = puzzle.PuzzleConfig(**CFG, dtype=torch.float32)
        net = jax_puzzle.Puzzle(cfg_j)
        params = jax.jit(net.init)(
            {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
            jnp.zeros((1, 32, 32, 3)))["params"]
    return net, jax.tree.map(np.asarray, params), cfg_t


def _port(cfg_t, params) -> puzzle.Puzzle:
    model = puzzle.Puzzle(cfg_t, device="meta")
    model.load_state_dict(puzzle_state_dict_from_flax(params, cfg_t),
                          assign=True)
    return model


def test_puzzle_forward_loss_and_grads_match_jax(tiny_puzzle):
    """logits, mask, loss, accuracy and every parameter's gradient."""
    net, params, cfg_t = tiny_puzzle
    x = _images(4, seed=3)
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        logits, m = net.apply({"params": p}, jnp.asarray(x), True,
                              rngs={"mask": key})
        loss, acc = jax_puzzle.puzzle_loss(logits, m)
        return loss, (logits, m, acc)

    (loss_j, (logits_j, mask_j, acc_j)), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, params))
    model = _port(cfg_t, params)
    logits, mask = model(torch.from_numpy(x),
                         torch.from_numpy(jax_noise(key, 4, 16)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    assert logits.dtype == torch.float32 and logits.shape == (4, 16, 16)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               atol=GOLDEN_TOL, rtol=0)
    loss, acc = puzzle.puzzle_loss(logits, mask)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=GOLDEN_TOL)
    assert acc.item() == float(acc_j)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    port = flatten(flax_from_state_dict(dict(zip(names, grads))))
    ref = flatten(jax.tree.map(np.asarray, grads_j))
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=GOLDEN_TOL, rtol=0,
                                   err_msg=k)
    back = flatten(flax_from_state_dict(model.state_dict()))
    for k, v in flatten(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_puzzle_loss_matches_jax_on_ties():
    """The cross-entropy against optax's and the accuracy's argmax on tied
    logits (the first index wins, as jnp.argmax)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 9, 9)).astype(np.float32)
    logits[0, 2] = 1.0                      # all tied: index 0 wins
    logits[1, 4, [1, 4]] = 5.0              # a tie with the target second
    mask = (rng.random((3, 9)) < 0.6).astype(np.float32)
    loss_j, acc_j = jax_puzzle.puzzle_loss(jnp.asarray(logits),
                                           jnp.asarray(mask))
    loss, acc = puzzle.puzzle_loss(torch.from_numpy(logits),
                                   torch.from_numpy(mask))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-6)
    assert acc.item() == float(acc_j)


def test_puzzle_train_and_eval_steps_match_jax(tiny_puzzle):
    """Three fp32 steps against the jitted JAX step with its per-step mask
    noise, then the eval step, then every parameter."""
    from vit_tpu.train.optim import make_optimizer as jax_make_optimizer
    from vit_tpu.train.state import TrainState as JaxTrainState
    from vit_tpu.train.step import make_puzzle_eval_step as jax_eval_fn
    from vit_tpu.train.step import make_puzzle_train_step as jax_step_fn

    net, params, cfg_t = tiny_puzzle
    opt = dict(lr=1e-3, warmup_steps=1, train_steps=100, min_lr=1e-4,
               weight_decay=0.05, clip_norm=None)
    step_j = jax.jit(jax_step_fn(net))
    state_j = JaxTrainState.create(jax.tree.map(jnp.asarray, params),
                                   jax_make_optimizer(**opt))
    model = _port(cfg_t, params)
    state = TrainState.create(model, make_optimizer(**opt))
    step = make_puzzle_train_step(model)
    rng = jax.random.PRNGKey(0)
    for i in range(3):
        x = _images(4, seed=10 + i)
        mask_rng, _ = jax.random.split(jax.random.fold_in(rng, i))
        state_j, m_j = step_j(state_j, jnp.asarray(x), rng)
        _, m = step(state, torch.from_numpy(x),
                    noise=torch.from_numpy(jax_noise(mask_rng, 4, 16)))
        assert set(m) == set(m_j) == {"train/loss", "train/pos_acc"}
        np.testing.assert_allclose(m["train/loss"].item(),
                                   float(m_j["train/loss"]), rtol=GOLDEN_TOL)
        assert m["train/pos_acc"].item() == pytest.approx(
            float(m_j["train/pos_acc"]), abs=1e-6)
    x = _images(6, seed=20)
    key = jax.random.PRNGKey(7)
    e_j = jax.jit(jax_eval_fn(net))(state_j.params, jnp.asarray(x), key)
    e = make_puzzle_eval_step(model)(
        torch.from_numpy(x), noise=torch.from_numpy(jax_noise(key, 6, 16)))
    assert set(e) == set(e_j) == {"valid/loss", "valid/pos_acc"}
    np.testing.assert_allclose(e["valid/loss"].item(), float(e_j["valid/loss"]),
                               rtol=GOLDEN_TOL)
    port = flatten(flax_from_state_dict(model.state_dict()))
    ref = flatten(jax.tree.map(np.asarray, state_j.params))
    start = flatten(params)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=GOLDEN_TOL, rtol=0,
                                   err_msg=k)
        moved, moved_ref = _moved(k, port[k], start[k], ref[k])
        rel = np.linalg.norm(moved - moved_ref) / np.linalg.norm(moved_ref)
        assert rel <= UPDATE_REL, (k, rel)


def test_load_puzzle_into_vit_matches_jax(tiny_puzzle):
    """patch projection, pos_emb and stack from the Puzzle, exactly; the
    extra token and head the classifier's own."""
    from vit_tpu.models.vit import ViTClassifier as JaxViTClassifier
    from vit_tpu.models.vit import ViTConfig as JaxViTConfig
    from vit_tpu_torch.bridge import classifier_state_dict_from_flax
    from vit_tpu_torch.models.vit import ViTConfig

    _, pz_params, _ = tiny_puzzle
    vit = dict(image_size=32, in_channels=3, patch_size=8,
               transformer="tiny", extra_tokens=1, dropout=0.0)
    with tiny_preset():
        cfg_vj = JaxViTConfig(**vit, dtype=jnp.float32)
        cfg_vt = ViTConfig(**vit, dtype=torch.float32)
        cfg_pt = puzzle.PuzzleConfig(**CFG, dtype=torch.float32)
        vit_params = jax.tree.map(np.asarray, jax.jit(
            JaxViTClassifier(cfg_vj, num_classes=10).init)(
                jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))["params"])
    ref = flatten(jax.tree.map(np.asarray, jax_puzzle.load_puzzle_into_vit(
        pz_params, vit_params)))
    got = puzzle.load_puzzle_into_vit(
        puzzle_state_dict_from_flax(pz_params, cfg_pt),
        classifier_state_dict_from_flax(vit_params, cfg_vt, 10))
    port = flatten(flax_from_state_dict(got))
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


TINY_ENTRY = ["--dataset", "synthetic", "--no_wandb", "--device", "cpu",
              "--transformer", "tiny", "--image_size", "32", "--patch_size",
              "8", "--bs", "4", "--steps_per_epoch", "3", "--log_every", "1",
              "--warmup_steps", "1"]


def _puzzle_entry(tmp_path, name: str, epochs: int, *extra: str):
    from vit_tpu_torch.train_puzzle import main

    with tiny_preset():
        return main(TINY_ENTRY + [
            "--epochs", str(epochs), "--ckpt_dir", str(tmp_path / name),
            "--run_dir", str(tmp_path / "runs"), *extra])


def test_train_puzzle_entry_resumes_and_hands_off(tmp_path, capsys):
    """Two epochs straight against one and a ``--resume``: the resumed
    epoch's losses and accuracies equal the straight run's; "best" by the
    highest validation position accuracy; then ``train_vit --init_from``
    that checkpoint (the INIT line, Puzzle's pos_emb in the classifier)."""
    import json

    from vit_tpu_torch.train.checkpoint import load_params

    straight = _puzzle_entry(tmp_path, "a", 2)
    assert all(np.isfinite(r["loss"]) and 0 <= r["pos_acc"] <= 1
               for r in straight["train"])
    _puzzle_entry(tmp_path, "b", 1)
    capsys.readouterr()
    resumed = _puzzle_entry(tmp_path, "b", 2, "--resume")
    assert "RESUMED data stream at epoch 1, batch 0" in capsys.readouterr().out
    want = [r for r in straight["train"] if r["epoch"] == 1]
    for got, ref in zip(resumed["train"], want):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        assert got["pos_acc"] == ref["pos_acc"]
    accs = [r["pos_acc"] for r in straight["valid"]]
    best = json.loads((tmp_path / "a" / "best_meta.json").read_text())
    assert best["best"] == max(accs)

    from vit_tpu_torch.train_vit import main as vit_main

    with tiny_preset():
        logs = vit_main(["--dataset", "synthetic", "--no_wandb", "--device",
                         "cpu", "--transformer", "tiny", "--image_size", "32",
                         "--patch_size", "8", "--bs", "4", "--num_classes",
                         "10", "--steps_per_epoch", "1", "--epochs", "1",
                         "--log_every", "1", "--init_from",
                         str(tmp_path / "a"), "--ckpt_dir",
                         str(tmp_path / "vit"), "--run_dir",
                         str(tmp_path / "runs")])
    assert np.isfinite(logs["train"][0]["loss"])
    assert f"INIT encoder from Puzzle checkpoint {tmp_path / 'a'}" in \
        capsys.readouterr().out
    # warmup 5000 from lr 0: the first step moves no weight
    pre = load_params(str(tmp_path / "a"))
    vit = load_params(str(tmp_path / "vit"), "last")
    assert torch.equal(vit["vit.pos_emb"], pre["pos_emb"])
    assert torch.equal(vit["vit.transformer.layers.1.mlp.fc2.weight"],
                       pre["transformer.layers.1.mlp.fc2.weight"])


@pytest.mark.parametrize("flags", [
    ["--scan_layers", "true"], ["--mesh", "1,1,1"], ["--attn_impl", "xla"],
    ["--dataset", "wds"],
], ids=lambda f: "_".join(a.lstrip("-") for a in f))
def test_train_puzzle_refuses_unported_flags(flags):
    from vit_tpu_torch.train_puzzle import main

    base = [] if flags[0] == "--dataset" else ["--dataset", "synthetic"]
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue A #|--wds_shards"):
        main(base + flags)
