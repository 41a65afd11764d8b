"""Port parity for the tokenizer training loop and its entry,
``python -m vit_tpu_torch.train_titok``: the shapes stream bit for bit, the
stream-resume, config and metric helpers, the metrics logger's files,
the loop's logged metrics against ``train_titok.py`` run as a subprocess
(fp32, from the same JAX init), resume against the uninterrupted run,
SIGTERM, and the flag surface against ``train_titok.py:parse_args``."""

import argparse
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.data.resume import resume_stream as jax_resume_stream
from vit_tpu.data.resume import set_stream_epoch as jax_set_stream_epoch
from vit_tpu.data.shapes_demo import ShapesImageLoader as JaxShapesLoader
from vit_tpu.data.synthetic import SyntheticImageLoader as JaxImageLoader
from vit_tpu.models.titok import TiTok as JaxTiTok
from vit_tpu.models.titok import TiTokConfig as JaxTiTokConfig
from vit_tpu.utils import config as jax_config
from vit_tpu.utils import metrics as jax_metrics
from vit_tpu_torch.bridge import state_dict_from_flax
from vit_tpu_torch.data.resume import resume_stream, set_stream_epoch
from vit_tpu_torch.data.shapes_demo import ShapesImageLoader
from vit_tpu_torch.data.synthetic import SyntheticImageLoader
from vit_tpu_torch.models.titok import TiTokConfig
from vit_tpu_torch.utils import config as port_config
from vit_tpu_torch.utils import metrics as port_metrics

ROOT = Path(__file__).resolve().parent.parent
# the tiny config of tests/test_data_resume.py:_run_titok, fp32
TINY = ["--dataset", "synthetic", "--transformer", "S", "--n_layers", "2",
        "--image_size", "16", "--patch_size", "8", "--latent_tokens", "4",
        "--codebook_size", "32", "--bs", "4", "--steps_per_epoch", "3",
        "--log_every", "1", "--warmup_steps", "2", "--train_steps", "100",
        "--image_every", "1000", "--no_wandb", "--mixed", "false"]
RUN = Path("titok-synthetic") / "8px_16px_S_4_32.jsonl"
METRIC_REL = 1e-5
# the loop against JAX's: the first three logged steps, then all six
LOOP_REL_FIRST, LOOP_REL_ALL = 1e-3, 1e-2


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


def _tiny_jax_params():
    cfg = JaxTiTokConfig(16, 8, 4, 32, 12, "S", dtype=jnp.float32)
    for name in ("enc_vit_config", "dec_vit_config"):
        sub = getattr(cfg, name)
        sub.trans_config = sub.trans_config.replace(n_layers=2)
    params = jax.jit(JaxTiTok(cfg).init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 16, 16, 3)))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny_params():
    return _tiny_jax_params()


def _tiny_port_config():
    cfg = TiTokConfig(16, 8, 4, 32, 12, "S", dtype=torch.float32)
    for name in ("enc_vit_config", "dec_vit_config"):
        sub = getattr(cfg, name)
        sub.trans_config = sub.trans_config.replace(n_layers=2)
    return cfg


def test_tree_norms_and_global_norm_match_jax(tiny_params):
    """The per-parameter norms under the JAX leaf names, and the global
    norm, from the same weights."""
    sd = state_dict_from_flax(tiny_params, _tiny_port_config())
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

def _jax_run(cwd: Path, epochs: int) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONUNBUFFERED="1",
               VIT_TPU_RUN_DIR=str(cwd / "runs"))
    env.pop("XLA_FLAGS", None)  # one device: no dp mesh over the tiny batch
    proc = subprocess.run(
        [sys.executable, str(ROOT / "train_titok.py"), *TINY,
         "--epochs", str(epochs), "--ckpt_dir", str(cwd / "ckpt")],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return _logged(cwd / "runs" / RUN)


def _logged(path: Path) -> dict:
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return {r["_step"]: r for r in rows if "train/loss" in r}


def _port_run(cwd: Path, epochs: int, *extra: str) -> dict:
    from vit_tpu_torch.train_titok import main

    main([*TINY, "--device", "cpu", "--epochs", str(epochs),
          "--ckpt_dir", str(cwd / "ckpt"), "--run_dir", str(cwd / "runs"),
          *extra])
    return _logged(cwd / "runs" / RUN)


@pytest.fixture
def jax_init(monkeypatch, tiny_params):
    """The port's loop starts from JAX's ``TiTok(cfg).init(PRNGKey(0))``."""
    from vit_tpu_torch.train import loop

    def init(model, seed):
        assert seed == 0
        model.load_state_dict(state_dict_from_flax(tiny_params,
                                                   model.config))

    monkeypatch.setattr(loop, "init_weights", init)


def test_loop_matches_train_titok(tmp_path, jax_init):
    """Two epochs × three steps of ``train_titok.py`` (a subprocess on the
    CPU) and of the port's ``main`` from the same init: each logged step's
    losses and gradient norm within 1e-3 relative on the first three
    steps and 1e-2 on all six, and the codebook usage equal. Reached on
    this config: 1.6e-6 on all six."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = _jax_run(tmp_path / "jax", 2)
    got = _port_run(tmp_path / "port", 2)
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


def test_resume_matches_uninterrupted_run(tmp_path, capsys):
    """Two epochs straight against one epoch, then ``--resume`` for the
    second: the same batches and the same losses (the counterpart of
    ``test_e2e_resume_matches_uninterrupted_run``)."""
    straight = _port_run(tmp_path / "a", 2)
    _port_run(tmp_path / "b", 1)
    capsys.readouterr()
    resumed = _port_run(tmp_path / "b", 2, "--resume")
    out = capsys.readouterr().out
    assert "RESUMED at step 3" in out, out
    assert "RESUMED data stream at epoch 1, batch 0" in out, out
    second = [s for s in straight if s > 3]
    assert second == [4, 5, 6]
    for s in second:
        for k in ("train/loss", "train/recon_loss"):
            np.testing.assert_allclose(resumed[s][k], straight[s][k],
                                       rtol=1e-6)


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
                tiny_params, _tiny_port_config()), "p")}
    assert set(norms[0]) - {"_step", "_ts"} == {
        k.replace("param_norm/p/", "param_norm/") for k in want}
    images = sorted(p.name for p in (tmp_path / "runs" / RUN).with_name(
        RUN.stem + "_images").iterdir())
    assert len(images) == 16 and "reconstructions_9_3.png" in images
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def _launch(ckpt_dir: Path, cwd: Path, *extra: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=str(ROOT))
    return subprocess.Popen(
        [sys.executable, "-m", "vit_tpu_torch.train_titok", "--device", "cpu",
         "--dataset", "synthetic", "--transformer", "S", "--n_layers", "2",
         "--image_size", "16", "--patch_size", "8", "--latent_tokens", "4",
         "--codebook_size", "32", "--bs", "4", "--epochs", "1",
         "--steps_per_epoch", "100000", "--log_every", "5",
         "--warmup_steps", "2", "--train_steps", "100000", "--no_wandb",
         "--mixed", "false", "--ckpt_dir", str(ckpt_dir),
         "--run_dir", str(cwd / "runs"), *extra],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _read_until(proc: subprocess.Popen, prefix: str, lines: list) -> bool:
    deadline = time.time() + 120
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            return False
        lines.append(line)
        if line.startswith(prefix):
            return True
    return False


def test_sigterm_saves_last_and_resume_continues(tmp_path):
    """SIGTERM after ``e=0 i=10``: exit 0, ``PREEMPTED``, "last" at step ≥
    10; ``--resume`` continues from it (the counterpart of
    ``tests/test_preempt.py``)."""
    ckpt_dir = tmp_path / "ckpt"
    proc = _launch(ckpt_dir, tmp_path)
    lines: list = []
    if not _read_until(proc, "e=0 i=10", lines):
        proc.kill()
        raise AssertionError("training never reached step 10:\n"
                             + "".join(lines))
    proc.send_signal(signal.SIGTERM)
    rest, _ = proc.communicate(timeout=120)
    out = "".join(lines) + rest
    assert proc.returncode == 0, out
    assert "PREEMPTED: saving 'last' at step" in out, out
    meta = json.loads((ckpt_dir / "last_meta.json").read_text())
    assert meta["step"] >= 10

    proc2 = _launch(ckpt_dir, tmp_path, "--resume")
    lines2: list = []
    try:
        assert _read_until(proc2, "RESUMED at step", lines2), "".join(lines2)
        assert int(lines2[-1].split()[-1]) == meta["step"]
        assert _read_until(proc2, "RESUMED data stream at epoch 0, batch "
                           f"{meta['step']}", lines2), "".join(lines2)
        assert _read_until(proc2, "e=0 i=", lines2), "".join(lines2)
        assert int(lines2[-1].split()[1][2:]) >= meta["step"]
    finally:
        proc2.send_signal(signal.SIGTERM)
        proc2.communicate(timeout=120)
    assert proc2.returncode == 0


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
    ["--dataset", "imagenet"], ["--dataset", "dmlab"],
    ["--dataset", "minecraft"], ["--quantizer", "fsq"],
    ["--attn_impl", "xla"], ["--scan_layers", "true"], ["--mesh", "1,1,1"],
    ["--pp_microbatches", "2"], ["--loader_backend", "grain"],
    ["--loader_processes", "2"], ["--ema_decay", "0.999"], ["--watch"],
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
