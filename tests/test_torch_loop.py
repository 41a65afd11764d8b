"""Port parity for the tokenizer training loop and its entry,
``python -m vit_tpu_torch.train_titok``: the shapes stream bit for bit, the
stream-resume, config and metric helpers, the metrics logger's files, the
loop's logged metrics against ``train_titok.py`` run as a subprocess (fp32,
from the same JAX init), and the flag surface against
``train_titok.py:parse_args``. Resume and SIGTERM are in
``test_torch_loop_resume.py``; EMA, image steps, the profile and the lifted
flags in ``test_torch_loop_steps.py`` (the three files share
``torch_loop_helpers.py``)."""

import argparse
import importlib.util
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.data.resume import resume_stream as jax_resume_stream
from vit_tpu.data.resume import set_stream_epoch as jax_set_stream_epoch
from vit_tpu.data.shapes_demo import ShapesImageLoader as JaxShapesLoader
from vit_tpu.data.synthetic import SyntheticImageLoader as JaxImageLoader
from vit_tpu.models.titok import TiTokConfig as JaxTiTokConfig
from vit_tpu.utils import config as jax_config
from vit_tpu.utils import metrics as jax_metrics
from torch_loop_helpers import (LOOP_REL_ALL, LOOP_REL_FIRST, METRIC_REL,
                                ROOT, jax_init, jax_run, port_run,
                                tiny_params, tiny_port_config)
from vit_tpu_torch.bridge import state_dict_from_flax
from vit_tpu_torch.data.resume import resume_stream, set_stream_epoch
from vit_tpu_torch.data.shapes_demo import ShapesImageLoader
from vit_tpu_torch.data.synthetic import SyntheticImageLoader
from vit_tpu_torch.models.titok import TiTokConfig
from vit_tpu_torch.utils import config as port_config
from vit_tpu_torch.utils import metrics as port_metrics

# -- the shapes stream --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_shapes_stream_matches_jax(seed):
    """Two epochs of ``SyntheticImageLoader(mode="shapes")`` and of
    ``ShapesImageLoader``, bit for bit."""
    kw = dict(steps_per_epoch=2, seed=seed)
    pairs = [(JaxImageLoader(16, 3, mode="shapes", **kw),
              SyntheticImageLoader(16, 3, mode="shapes", **kw)),
             (JaxShapesLoader(16, 3, **kw), ShapesImageLoader(16, 3, **kw))]
    for ref, port in pairs:
        for _ in range(2):
            n = 0
            for (xr, yr), (xp, yp) in zip(ref, port):
                assert xp.dtype == xr.dtype == np.float32
                np.testing.assert_array_equal(xp, xr)
                if yr is None:
                    assert yp is None
                else:
                    np.testing.assert_array_equal(yp, yr)
                n += 1
            assert n == 2


# -- stream resume, config, metrics ------------------------------------------

@pytest.mark.parametrize("epoch, skip", [(0, 2), (1, 1), (1, 5)],
                         ids=["within", "second_epoch", "past_the_end"])
def test_resume_stream_matches_jax(epoch, skip):
    """``set_stream_epoch`` through a ``.dataset`` chain, then
    ``resume_stream``: the same batches as the JAX helpers on the JAX
    loader (none past the end), and the next epoch whole."""

    class Outer:
        def __init__(self, dataset):
            self.dataset = dataset

    kw = dict(steps_per_epoch=3, seed=7, mode="shapes")
    ref, port = JaxImageLoader(8, 2, **kw), SyntheticImageLoader(8, 2, **kw)
    assert jax_set_stream_epoch(Outer(ref), epoch)
    assert set_stream_epoch(Outer(port), epoch)
    assert not set_stream_epoch(object(), epoch)
    got = [x for x, _ in resume_stream(port, skip)]
    want = [x for x, _ in jax_resume_stream(ref, skip)]
    assert len(got) == len(want) == max(0, 3 - skip)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(next(iter(port))[0], next(iter(ref))[0])


@pytest.mark.parametrize("value", [True, False, "true", "T", "yes", "Y", "1",
                                   "False", "f", "no", "n", "0", "maybe", ""])
def test_str2bool_matches_jax(value):
    try:
        want = jax_config.str2bool(value)
    except argparse.ArgumentTypeError:
        with pytest.raises(argparse.ArgumentTypeError):
            port_config.str2bool(value)
        return
    assert port_config.str2bool(value) is want


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dataclass_from_dict_reads_both_packages_configs(dtype):
    """A TiTok config written by either package's checkpointer rebuilds
    the port's config: the init fields as JAX rebuilds them from the JAX
    dict, dtypes as torch dtypes, derived fields derived again."""
    from vit_tpu.train.checkpoint import _config_to_dict as jax_to_dict
    from vit_tpu_torch.train.checkpoint import _config_to_dict

    args = (64, 8, 32, 1024, 12, "S")
    jcfg = JaxTiTokConfig(*args, dtype=getattr(jnp, dtype))
    tcfg = TiTokConfig(*args, dtype=getattr(torch, dtype))
    ref = jax_config.dataclass_from_dict(JaxTiTokConfig, json.loads(
        json.dumps(jax_to_dict(jcfg))))
    for data in (jax_to_dict(jcfg), _config_to_dict(tcfg)):
        got = port_config.dataclass_from_dict(
            TiTokConfig, json.loads(json.dumps(data)))
        assert got.dtype == getattr(torch, dtype)
        assert got.param_dtype == torch.float32
        for f in ("image_size", "patch_size", "latent_tokens",
                  "codebook_size", "latent_dim", "transformer", "grid_size",
                  "n_patches", "n_embd"):
            assert getattr(got, f) == getattr(ref, f), f


def _image_pair(seed: int, size: int = 24):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("fn", ["psnr", "ssim"])
def test_image_metrics_match_jax(fn):
    a, b = _image_pair(1)
    want = np.asarray(getattr(jax_metrics, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(port_metrics, fn)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=METRIC_REL)


def test_tree_norms_and_global_norm_match_jax(tiny_params):
    """The per-parameter norms under the JAX leaf names, and the global
    norm, from the same weights."""
    sd = state_dict_from_flax(tiny_params, tiny_port_config())
    want = jax_metrics.tree_norms(tiny_params, "param_norm")
    got = port_metrics.tree_norms(sd, "param_norm")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=METRIC_REL)
    np.testing.assert_allclose(
        port_metrics.global_norm(list(sd.values())).item(),
        float(jax_metrics.global_norm(tiny_params)), rtol=METRIC_REL)


def test_metrics_logger_writes_the_jax_files(tmp_path, monkeypatch):
    """The same paths and records as the JAX logger: the ``_config`` line
    (``_platform`` "cpu"), ``_step``/``_ts`` records, and PNGs whose pixels
    equal those PIL writes for the JAX logger."""
    from PIL import Image

    from vit_tpu.utils.logging import MetricsLogger as JaxLogger
    from vit_tpu_torch.utils.logging import MetricsLogger

    imgs = {"images": _image_pair(2, 12)[0][:2]}
    config = {"lr": 1e-4, "mixed": False, "run_dir": None, "skip": [1]}
    for side, cls in (("jax", JaxLogger), ("port", MetricsLogger)):
        kw = dict(use_wandb=False) if side == "jax" else {}
        log = cls("proj", "run", config=config, out_dir=str(tmp_path / side),
                  tb=False, **kw)
        log.log({"train/loss": np.float32(0.5), "train/epoch": 0}, step=3)
        log.log_images(imgs, step=3)
        log.close()
    rows = {side: [json.loads(line) for line in
                   (tmp_path / side / "proj" / "run.jsonl").read_text()
                   .splitlines()] for side in ("jax", "port")}
    assert rows["port"][0]["_config"] == rows["jax"][0]["_config"]
    assert rows["port"][0]["_platform"] == "cpu"
    for r in rows.values():
        for k in ("_ts",):
            for row in r:
                row.pop(k)
    assert rows["port"][1:] == rows["jax"][1:]
    names = sorted(p.name for p in
                   (tmp_path / "jax" / "proj" / "run_images").iterdir())
    assert names == ["images_3_0.png", "images_3_1.png"]
    for name in names:
        got = np.asarray(Image.open(tmp_path / "port" / "proj" / "run_images"
                                    / name))
        want = np.asarray(Image.open(tmp_path / "jax" / "proj" / "run_images"
                                     / name))
        assert got.shape == (12, 12, 3)
        np.testing.assert_array_equal(got, want)


# -- the loop against train_titok.py ----------------------------------------

def test_loop_matches_train_titok(tmp_path, jax_init):
    """Two epochs × three steps of ``train_titok.py`` (a subprocess on the
    CPU) and of the port's ``main`` from the same init: each logged step's
    losses and gradient norm within 1e-3 relative on the first three
    steps and 1e-2 on all six, and the codebook usage equal. Reached on
    this config: 1.6e-6 on all six."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = jax_run(tmp_path / "jax", 2)
    got = port_run(tmp_path / "port", 2)
    assert sorted(got) == sorted(ref) == [1, 2, 3, 4, 5, 6]
    for step in ref:
        rtol = LOOP_REL_FIRST if step <= 3 else LOOP_REL_ALL
        for k in ("train/loss", "train/recon_loss", "train/quant_loss",
                  "train/grad_norm"):
            np.testing.assert_allclose(got[step][k], ref[step][k], rtol=rtol,
                                       err_msg=f"{k} at step {step}")
        assert got[step]["train/codebook_usage"] == \
            ref[step]["train/codebook_usage"]
        assert got[step]["train/epoch"] == ref[step]["train/epoch"]


# -- the flag surface ---------------------------------------------------------

def test_flags_and_defaults_match_train_titok(monkeypatch):
    """Every flag ``train_titok.py`` takes, with its default; the port adds
    ``--device`` only."""
    from vit_tpu_torch.train_titok import parse_args

    spec = importlib.util.spec_from_file_location("jax_train_titok",
                                                  ROOT / "train_titok.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["train_titok.py"])
    want = vars(mod.parse_args())
    got = vars(parse_args([]))
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    assert got["min_lr"] == got["lr"] / 10


@pytest.mark.parametrize("flags", [
    ["--attn_impl", "xla"], ["--scan_layers", "true"], ["--mesh", "1,1,1"],
    ["--pp_microbatches", "2"],
], ids=lambda f: "_".join(a.lstrip("-") for a in f))
def test_train_titok_refuses_unported_flags(flags):
    """Each flag whose path is not ported raises before anything is built,
    naming its ROADMAP item."""
    from vit_tpu_torch.train_titok import main

    base = [] if flags[:1] == ["--dataset"] else ["--dataset", "synthetic"]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A #"):
        main(base + flags + ["--device", "cpu"])


def test_no_card_exits_nonzero(monkeypatch, tmp_path):
    """``--device cuda`` (the default) without a card stops with a message
    before anything is built or written."""
    from vit_tpu_torch.train_titok import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["--dataset", "synthetic", "--ckpt_dir", str(tmp_path / "c")])
    assert e.value.code not in (0, None) and "no CUDA device" in str(
        e.value.code)
    assert not (tmp_path / "c").exists()
