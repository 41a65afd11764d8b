"""Port parity for MAE pretraining (``vit_tpu_torch/models/mae.py``,
``train/step.py``'s MAE steps, ``python -m vit_tpu_torch.train_mae`` and
``train_vit --init_from``): the tiny "tiny" preset encoder (2 layers × 2
heads × 64) and a decoder of 2 layers × 4 heads × 32 (head_dim 32, as
MAE-B's 16 × 512) at image 32, patch 8, against the JAX package, fp32, from
JAX init weights carried over with the bridge and JAX's own mask noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_noise, moved_params as _moved
from torch_port_helpers import tiny_preset
from vit_tpu.models import mae as jax_mae
from vit_tpu.models.enhancing_vqgan import \
    sincos_2d_pos_embed as jax_sincos
from vit_tpu_torch.bridge import (flatten, flax_from_state_dict,
                                  mae_state_dict_from_flax)
from vit_tpu_torch.models import mae
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState
from vit_tpu_torch.train.step import make_mae_eval_step, make_mae_train_step

GOLDEN_TOL = 1e-3   # BASELINE.md's golden contract, fp32 on both sides
UPDATE_REL = 1e-2   # each parameter's change over three steps vs JAX's
CFG = dict(image_size=32, patch_size=8, transformer="tiny", decoder_layers=2,
           decoder_heads=4, decoder_embd=128)


def _images(n, seed):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (n, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny_mae():
    """(JAX model, its init params as numpy, the port's fp32 config) for
    norm_pix on and off: one init, since norm_pix is the loss's alone."""
    with tiny_preset():
        out, params = {}, None
        for norm_pix in (True, False):
            cfg_j = jax_mae.MAEConfig(**CFG, norm_pix=norm_pix,
                                      dtype=jnp.float32, attn_impl="xla")
            cfg_t = mae.MAEConfig(**CFG, norm_pix=norm_pix,
                                  dtype=torch.float32)
            net = jax_mae.MAE(cfg_j)
            if params is None:
                params = jax.tree.map(np.asarray, jax.jit(net.init)(
                    {"params": jax.random.PRNGKey(0),
                     "mask": jax.random.PRNGKey(1)},
                    jnp.zeros((1, 32, 32, 3)))["params"])
            out[norm_pix] = (net, params, cfg_t)
    return out


def _port(cfg_t, params) -> mae.MAE:
    model = mae.MAE(cfg_t, device="meta")
    model.load_state_dict(mae_state_dict_from_flax(params, cfg_t),
                          assign=True)
    return model


@pytest.mark.parametrize("dim, grid", [(128, 4), (512, 16), (768, 14),
                                       (32, 3)])
def test_sincos_matches_jax(dim, grid):
    """The port's copy of the table, exactly (float64, then float32)."""
    np.testing.assert_array_equal(mae.sincos_2d_pos_embed(dim, grid),
                                  jax_sincos(dim, grid))


def test_patchify_matches_jax():
    x = _images(2, 0)
    p = mae.patchify(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(p.numpy(),
                                  np.asarray(jax_mae.patchify(x, 8)))
    back = mae.unpatchify(p, 8, 4)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_mae.unpatchify(jnp.asarray(p.numpy()),
                                                    8, 4)))


@pytest.mark.parametrize("b, n, len_keep", [(4, 16, 4), (3, 256, 64),
                                            (2, 49, 12)])
def test_random_masking_matches_jax(b, n, len_keep):
    """ids_keep, ids_restore and mask equal JAX's on JAX's noise."""
    key = jax.random.PRNGKey(n + b)
    ids_keep_j, ids_restore_j, mask_j = jax_mae.random_masking(key, b, n,
                                                               len_keep)
    noise = torch.from_numpy(np.asarray(jax.random.uniform(key, (b, n))))
    ids_keep, ids_restore, mask = mae.random_masking(noise, len_keep)
    np.testing.assert_array_equal(ids_keep.numpy(), np.asarray(ids_keep_j))
    np.testing.assert_array_equal(ids_restore.numpy(),
                                  np.asarray(ids_restore_j))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    assert mask.sum().item() == b * (n - len_keep)


def test_config_matches_jax():
    """len_keep by Python's round and the stacks' shapes, at the defaults
    and at ratios whose product lands on .5."""
    with tiny_preset():
        for ratio, image in ((0.75, 256), (0.5, 32), (0.875, 32),
                             (0.9, 224)):
            j = jax_mae.MAEConfig(image, mask_ratio=ratio)
            t = mae.MAEConfig(image, mask_ratio=ratio)
            assert (t.len_keep, t.n_patches, t.patch_dim, t.grid_size) == \
                (j.len_keep, j.n_patches, j.patch_dim, j.grid_size)
            for a, b in ((t.enc_config, j.enc_config),
                         (t.dec_config, j.dec_config)):
                assert (a.n_layers, a.n_heads, a.n_embd, a.block_size) == \
                    (b.n_layers, b.n_heads, b.n_embd, b.block_size)
    # MAE-B's decoder: head_dim 32, S 257, the packed kernels' shape
    d = mae.MAEConfig(256).dec_config
    assert (d.n_embd // d.n_heads, d.block_size) == (32, 257)


@pytest.mark.parametrize("norm_pix", [True, False])
def test_mae_forward_loss_and_grads_match_jax(tiny_mae, norm_pix):
    """pred, mask, the loss and every parameter's gradient, fp32, on JAX's
    mask noise."""
    net, params, cfg_t = tiny_mae[norm_pix]
    x = _images(4, seed=3)
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        pred, m = net.apply({"params": p}, jnp.asarray(x), True,
                            rngs={"mask": key})
        return jax_mae.mae_loss(pred, jnp.asarray(x), m, 8, norm_pix), (pred,
                                                                        m)

    (loss_j, (pred_j, mask_j)), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, params))
    model = _port(cfg_t, params)
    noise = torch.from_numpy(jax_noise(key, 4, cfg_t.n_patches))
    pred, mask = model(torch.from_numpy(x), noise)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    assert pred.dtype == torch.float32 and pred.shape == (4, 16, 192)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(pred_j),
                               atol=GOLDEN_TOL, rtol=0)
    loss = mae.mae_loss(pred, torch.from_numpy(x), mask, 8, norm_pix)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=GOLDEN_TOL)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    port = flatten(flax_from_state_dict(dict(zip(names, grads))))
    ref = flatten(jax.tree.map(np.asarray, grads_j))
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=GOLDEN_TOL, rtol=0,
                                   err_msg=k)
    # the bridge reads the {"encoder": …, "decoder": …} tree and back
    back = flatten(flax_from_state_dict(model.state_dict()))
    for k, v in flatten(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_reconstruct_matches_jax(tiny_mae):
    net, params, cfg_t = tiny_mae[True]
    x = _images(2, seed=4)
    key = jax.random.PRNGKey(6)
    img_j, mask_j = jax.jit(lambda p, x: net.apply(
        {"params": p}, x, True, rngs={"mask": key},
        method=jax_mae.MAE.reconstruct))(jax.tree.map(jnp.asarray, params),
                                         jnp.asarray(x))
    with torch.no_grad():
        img, mask = _port(cfg_t, params).reconstruct(
            torch.from_numpy(x),
            torch.from_numpy(jax_noise(key, 2, cfg_t.n_patches)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j),
                               atol=GOLDEN_TOL, rtol=0)
    # visible patches are the input's
    kept = mae.patchify(img, 8)[mask == 0]
    np.testing.assert_array_equal(
        kept.numpy(), mae.patchify(torch.from_numpy(x), 8)[mask == 0].numpy())


def _opt():
    return dict(lr=1e-3, warmup_steps=1, train_steps=100, min_lr=1e-4,
                weight_decay=0.05, clip_norm=None)


def test_mae_train_steps_match_jax(tiny_mae):
    """Three fp32 steps against the jitted JAX step, each fed the JAX
    step's own mask noise (its key folded with the step, then split):
    the loss per step, then every parameter and its change."""
    from vit_tpu.train.optim import make_optimizer as jax_make_optimizer
    from vit_tpu.train.state import TrainState as JaxTrainState
    from vit_tpu.train.step import make_mae_train_step as jax_step_fn

    net, params, cfg_t = tiny_mae[True]
    step_j = jax.jit(jax_step_fn(net))
    state_j = JaxTrainState.create(jax.tree.map(jnp.asarray, params),
                                   jax_make_optimizer(**_opt()))
    model = _port(cfg_t, params)
    state = TrainState.create(model, make_optimizer(**_opt()))
    step = make_mae_train_step(model)
    rng = jax.random.PRNGKey(0)
    for i in range(3):
        x = _images(4, seed=10 + i)
        mask_rng, _ = jax.random.split(jax.random.fold_in(rng, i))
        noise = torch.from_numpy(jax_noise(mask_rng, 4, cfg_t.n_patches))
        state_j, m_j = step_j(state_j, jnp.asarray(x), rng)
        _, m = step(state, torch.from_numpy(x), noise=noise)
        assert set(m) == set(m_j) == {"train/loss"}
        np.testing.assert_allclose(m["train/loss"].item(),
                                   float(m_j["train/loss"]), rtol=GOLDEN_TOL,
                                   err_msg=f"step {i}")
    assert state.step.item() == 3
    port = flatten(flax_from_state_dict(model.state_dict()))
    ref = flatten(jax.tree.map(np.asarray, state_j.params))
    start = flatten(params)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=GOLDEN_TOL, rtol=0,
                                   err_msg=k)
        moved, moved_ref = _moved(k, port[k], start[k], ref[k])
        assert np.linalg.norm(moved_ref) > 0, k
        rel = np.linalg.norm(moved - moved_ref) / np.linalg.norm(moved_ref)
        assert rel <= UPDATE_REL, (k, rel)


def test_mae_eval_step_matches_jax(tiny_mae):
    from vit_tpu.train.step import make_mae_eval_step as jax_eval_fn

    net, params, cfg_t = tiny_mae[False]
    x = _images(6, seed=8)
    key = jax.random.PRNGKey(7)
    m_j = jax.jit(jax_eval_fn(net))(jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(x), key)
    model = _port(cfg_t, params).train()
    m = make_mae_eval_step(model)(
        torch.from_numpy(x),
        noise=torch.from_numpy(jax_noise(key, 6, cfg_t.n_patches)))
    assert set(m) == set(m_j) == {"valid/loss"}
    np.testing.assert_allclose(m["valid/loss"].item(), float(m_j["valid/loss"]),
                               rtol=GOLDEN_TOL)
    assert model.training   # the step restores the model's mode


def test_steps_draw_masks_from_the_generator(tiny_mae):
    """Without noise the mask comes from the generator: one seed, one mask;
    another seed, another."""
    _, params, cfg_t = tiny_mae[True]
    model = _port(cfg_t, params)
    x = torch.from_numpy(_images(3, seed=1))
    masks = []
    for seed in (1, 1, 2):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            masks.append(model(x, generator=gen)[1])
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    assert (masks[0].sum(1) == cfg_t.n_patches - cfg_t.len_keep).all()


def test_load_encoder_into_vit_matches_jax(tiny_mae):
    """The classifier's parameters after the hand-off equal JAX's, exactly:
    patch projection, stack and cls → extra_emb[0] from the MAE, pos_emb
    and head the classifier's own."""
    from vit_tpu.models.vit import ViTClassifier as JaxViTClassifier
    from vit_tpu.models.vit import ViTConfig as JaxViTConfig
    from vit_tpu_torch.bridge import classifier_state_dict_from_flax
    from vit_tpu_torch.models.vit import ViTConfig

    _, mae_params, cfg_t = tiny_mae[True]
    vit = dict(image_size=32, in_channels=3, patch_size=8,
               transformer="tiny", extra_tokens=1, dropout=0.0)
    with tiny_preset():
        cfg_vj = JaxViTConfig(**vit, dtype=jnp.float32)
        cfg_vt = ViTConfig(**vit, dtype=torch.float32)
        vit_params = jax.tree.map(np.asarray, jax.jit(
            JaxViTClassifier(cfg_vj, num_classes=10).init)(
                jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))["params"])
    ref = flatten(jax.tree.map(np.asarray, jax_mae.load_encoder_into_vit(
        mae_params, vit_params)))
    got = mae.load_encoder_into_vit(
        mae_state_dict_from_flax(mae_params, cfg_t),
        classifier_state_dict_from_flax(vit_params, cfg_vt, 10))
    port = flatten(flax_from_state_dict(got))
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(port["vit/extra_emb"][0],
                                  mae_params["encoder"]["cls_token"][0])


TINY_ENTRY = ["--dataset", "synthetic", "--no_wandb", "--device", "cpu",
              "--transformer", "tiny", "--image_size", "32", "--patch_size",
              "8", "--decoder_layers", "1", "--decoder_heads", "4",
              "--decoder_embd", "128", "--bs", "4", "--steps_per_epoch", "2",
              "--log_every", "1", "--warmup_steps", "1"]


def _mae_entry(tmp_path, name: str, epochs: int, *extra: str):
    from vit_tpu_torch.train_mae import main

    with tiny_preset():
        return main(TINY_ENTRY + [
            "--epochs", str(epochs), "--ckpt_dir", str(tmp_path / name),
            "--run_dir", str(tmp_path / "runs"), *extra])


@pytest.fixture(scope="module")
def straight_run(tmp_path_factory):
    """Two epochs of the tiny entry: (its logs, its directory)."""
    tmp = tmp_path_factory.mktemp("mae_entry")
    return _mae_entry(tmp, "a", 2), tmp


def test_train_mae_entry_checkpoints_and_resumes(tmp_path, capsys,
                                                 straight_run):
    """Two epochs straight against one epoch and a ``--resume`` for the
    second: the resumed epoch's losses equal the straight run's (the masks
    replay: each step's generator is seeded by the step); "best" holds the
    lowest validation loss, "last" the final step, and the log its
    records."""
    import json

    from vit_tpu_torch.train.checkpoint import load_params

    straight, home = straight_run
    assert [r["i"] for r in straight["train"]] == [0, 1] * 2
    assert all(np.isfinite(r["loss"]) for r in straight["train"])
    _mae_entry(tmp_path, "b", 1)
    capsys.readouterr()
    resumed = _mae_entry(tmp_path, "b", 2, "--resume")
    out = capsys.readouterr().out
    assert "RESUMED data stream at epoch 1, batch 0" in out
    want = [r for r in straight["train"] if r["epoch"] == 1]
    assert [r["i"] for r in resumed["train"]] == [r["i"] for r in want]
    for got, ref in zip(resumed["train"], want):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
    losses = [r["loss"] for r in straight["valid"]]
    best = json.loads((home / "a" / "best_meta.json").read_text())
    assert best["best"] == min(losses)
    assert json.loads((home / "a" / "last_meta.json").read_text()
                      )["step"] == 4
    assert any(k.startswith("encoder.") for k in load_params(str(home / "a")))
    rows = [json.loads(line) for line in (
        home / "runs" / "mae" /
        "mae_8px_32px_tiny_0.75mr_4bs_0.00015lr.jsonl").read_text()
        .splitlines()]
    assert rows[0]["_config"]["decoder_heads"] == 4
    assert [r["_step"] for r in rows if "train/loss" in r][:2] == [1, 2]


def test_train_mae_matches_its_steps(straight_run):
    """The entry's first logged loss equals the train step's on the
    entry's first batch, model init and step-0 generator."""
    from vit_tpu_torch.data.synthetic import SyntheticImageLoader
    from vit_tpu_torch.utils.init import init_params_

    logs = straight_run[0]
    with tiny_preset():
        cfg = mae.MAEConfig(**{**CFG, "decoder_layers": 1},
                            dtype=torch.bfloat16)
        model = mae.MAE(cfg)
    init_params_(model, torch.Generator().manual_seed(0))
    images, _ = next(iter(SyntheticImageLoader(32, 4, steps_per_epoch=2,
                                               seed=0)))
    state = TrainState.create(model, make_optimizer(**{
        **_opt(), "lr": 1.5e-4, "min_lr": 1.5e-5, "train_steps": 500000}))
    gen = torch.Generator().manual_seed(0)
    _, m = make_mae_train_step(model)(state, torch.from_numpy(images), gen)
    np.testing.assert_allclose(logs["train"][0]["loss"], m["train/loss"].item(),
                               rtol=1e-6)


@pytest.mark.parametrize("flags", [
    ["--scan_layers", "true"], ["--mesh", "1,1,1"], ["--pp_microbatches", "2"],
    ["--attn_impl", "xla"],
], ids=lambda f: "_".join(a.lstrip("-") for a in f))
def test_train_mae_refuses_unported_flags(flags):
    from vit_tpu_torch.train_mae import main

    with pytest.raises(NotImplementedError, match="ROADMAP Queue A #"):
        main(["--dataset", "synthetic"] + flags)


@pytest.mark.parametrize("flags, why", [
    (["--dataset", "wds"], "--wds_shards"),
    (["--dataset", "imagenet"], "--data_dir"),
])
def test_train_mae_refuses_missing_data(flags, why):
    from vit_tpu_torch.train_mae import main

    with pytest.raises((NotImplementedError, FileNotFoundError, ValueError),
                       match=why):
        main(flags)


def test_train_mae_flags_and_defaults_match_train_mae(monkeypatch):
    """Every flag of ``train_mae.py`` with its default (the JAX data
    directory aside), plus the port's ``--device``."""
    import importlib
    import sys
    from pathlib import Path

    from vit_tpu_torch.train_mae import parse_args

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    monkeypatch.setattr(sys, "argv", ["train_mae.py"])
    ref = vars(importlib.import_module("train_mae").parse_args())
    got = vars(parse_args([]))
    assert set(got) - set(ref) == {"device"}
    for k, v in ref.items():
        if k == "data_dir":
            continue
        assert got[k] == v, k


def test_train_vit_init_from_mae(capsys, straight_run):
    """``train_vit --init_from`` an MAE checkpoint: the INIT line, and the
    classifier's first logits equal those of one that
    ``load_encoder_into_vit`` built from the same checkpoint."""
    from vit_tpu_torch.models.vit import ViTClassifier, ViTConfig
    from vit_tpu_torch.train.checkpoint import load_params
    from vit_tpu_torch.train_vit import init_from
    from vit_tpu_torch.utils.init import init_params_

    directory = straight_run[1] / "a"
    pre = load_params(str(directory))
    with tiny_preset():
        cfg = ViTConfig(32, 3, 8, "tiny", 1, 0.0, dtype=torch.float32)
        a, b = (ViTClassifier(cfg, 10) for _ in range(2))
    for model in (a, b):
        init_params_(model, torch.Generator().manual_seed(0))
    assert init_from(a, str(directory)) == "MAE"
    assert f"INIT encoder from MAE checkpoint {directory}" in \
        capsys.readouterr().out
    b.load_state_dict(mae.load_encoder_into_vit(pre, b.state_dict()))
    x = torch.from_numpy(_images(2, seed=9))
    with torch.no_grad():
        assert torch.equal(a.eval()(x), b.eval()(x))
    torch.testing.assert_close(a.vit.extra_emb[0], pre["encoder.cls_token"][0],
                               rtol=0, atol=0)
