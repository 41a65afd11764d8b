"""Port parity for the tokenizer loop's per-step extras
(``python -m vit_tpu_torch.train_titok``): the ``--ema_decay`` loop against
``train_titok.py`` run as a subprocess, the image steps (PNGs, SSIM,
parameter norms) and the profile, and the lifted flags (``--quantizer
fsq``, ``--ema_decay``, ``--watch``). Moved whole from
``test_torch_loop.py``, whose one xdist worker set the suite's wall
time."""

import json

import jax
import numpy as np
import pytest
import torch

from torch_loop_helpers import (EMA_REL, LOOP_REL_FIRST, RUN, TINY, jax_init,
                                jax_run, port_run, tiny_params,
                                tiny_port_config)
from vit_tpu_torch.bridge import state_dict_from_flax
from vit_tpu_torch.utils import metrics as port_metrics


def test_ema_loop_matches_train_titok(tmp_path, jax_init):
    """One epoch of three steps with ``--ema_decay 0.9`` through
    ``train_titok.py`` and through the port's ``main``: the logged losses
    as in ``test_loop_matches_train_titok``, and the "last" checkpoints'
    averages (JAX's ``load_params(..., ema=True)``, the port's) within
    ``EMA_REL`` relative in each tensor's L2 norm (reached: 4.1e-7)."""
    from vit_tpu.train.checkpoint import load_params as jax_load_params
    from vit_tpu_torch.bridge import flatten, flax_from_state_dict
    from vit_tpu_torch.train.checkpoint import load_params

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = jax_run(tmp_path / "jax", 1, "--ema_decay", "0.9")
    got = port_run(tmp_path / "port", 1, "--ema_decay", "0.9")
    assert sorted(got) == sorted(ref) == [1, 2, 3]
    for step in ref:
        for k in ("train/loss", "train/recon_loss", "train/grad_norm"):
            np.testing.assert_allclose(got[step][k], ref[step][k],
                                       rtol=LOOP_REL_FIRST, err_msg=k)
    want = flatten(jax.tree.map(np.asarray, jax_load_params(
        str(tmp_path / "jax" / "ckpt"), "last", ema=True)))
    ema = load_params(str(tmp_path / "port" / "ckpt"), "last", ema=True)
    params = load_params(str(tmp_path / "port" / "ckpt"), "last")
    have = flatten(flax_from_state_dict(ema))
    assert have.keys() == want.keys()
    worst = {k: float(np.linalg.norm(have[k] - want[k])
                      / np.linalg.norm(want[k])) for k in want}
    for k in want:
        assert worst[k] <= EMA_REL, (k, worst[k])
    assert any(not torch.equal(ema[n], params[n]) for n in params)


def test_image_steps_and_profile(tmp_path, jax_init, tiny_params):
    """``--image_every`` steps log the first four inputs and
    reconstructions as PNGs, their SSIM and each parameter's norm under its
    JAX name; ``--profile_dir`` writes a Chrome trace of steps 10-15."""
    from vit_tpu_torch.train_titok import main

    main([*TINY, "--device", "cpu", "--epochs", "1", "--steps_per_epoch",
          "16", "--image_every", "8", "--log_every", "8",
          "--profile_dir", str(tmp_path / "prof"),
          "--ckpt_dir", str(tmp_path / "ckpt"),
          "--run_dir", str(tmp_path / "runs")])
    rows = [json.loads(line) for line in
            (tmp_path / "runs" / RUN).read_text().splitlines()]
    ssim_steps = [r["_step"] for r in rows if "train/ssim" in r]
    assert ssim_steps == [1, 9]
    norms = [r for r in rows if any(k.startswith("param_norm/") for k in r)]
    assert [r["_step"] for r in norms] == [1, 9]
    want = {"param_norm/" + k for k in
            port_metrics.tree_norms(state_dict_from_flax(
                tiny_params, tiny_port_config()), "p")}
    assert set(norms[0]) - {"_step", "_ts"} == {
        k.replace("param_norm/p/", "param_norm/") for k in want}
    images = sorted(p.name for p in (tmp_path / "runs" / RUN).with_name(
        RUN.stem + "_images").iterdir())
    assert len(images) == 16 and "reconstructions_9_3.png" in images
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("flags", [
    ["--quantizer", "fsq"], ["--ema_decay", "0.999"], ["--watch"],
], ids=lambda f: "_".join(a.lstrip("-") for a in f))
def test_train_titok_lifted_flags(tmp_path, flags):
    """The flags ported since the first loop run through ``main`` (two
    steps of the tiny config, logged): ``--quantizer fsq`` builds an FSQ
    TiTok (no codebook parameter, a zero quantizer loss, its config saved);
    ``--ema_decay`` saves an average that moved apart from the parameters;
    ``--watch`` writes a gradient and a parameter histogram per tensor at
    each log step to TensorBoard, each counting the tensor's elements."""
    from vit_tpu_torch.train.checkpoint import has_ema, load_params

    logged = port_run(tmp_path, 1, "--steps_per_epoch", "2", *flags)
    assert sorted(logged) == [1, 2]
    params = load_params(str(tmp_path / "ckpt"), "last")
    config = json.loads((tmp_path / "ckpt" / "last_config.json").read_text())
    if flags[0] == "--quantizer":
        assert config["quantizer"] == "fsq"
        assert not any("codebook" in n for n in params)
        assert all(r["train/quant_loss"] == 0.0 for r in logged.values())
    elif flags[0] == "--ema_decay":
        assert config["quantizer"] == "vq"
        assert has_ema(str(tmp_path / "ckpt"), "last")
        ema = load_params(str(tmp_path / "ckpt"), "last", ema=True)
        assert list(ema) == list(params)
        assert any(not torch.equal(ema[n], params[n]) for n in params)
    else:
        from tensorboard.backend.event_processing.event_accumulator import \
            EventAccumulator

        acc = EventAccumulator(str((tmp_path / "runs" / RUN).with_name(
            RUN.stem + "_tb")), size_guidance={"histograms": 0})
        acc.Reload()
        tags = acc.Tags()["histograms"]
        sizes = {port_metrics.tree_norms({n: t}, "h").popitem()[0][2:]:
                 t.numel() for n, t in params.items()}
        assert sorted(tags) == sorted([f"grad_hist/{k}" for k in sizes]
                                      + [f"param_hist/{k}" for k in sizes])
        for tag in tags:
            events = acc.Histograms(tag)
            assert [e.step for e in events] == [1, 2]
            assert all(e.histogram_value.num == sizes[tag.split("/", 1)[1]]
                       for e in events)
