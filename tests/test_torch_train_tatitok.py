"""Port parity for ``python -m vit_tpu_torch.train_tatitok``: the flag
surface against ``train_tatitok.py:parse_args``; the logged metrics of the
port's ``main`` against ``train_tatitok.py`` run as a subprocess (fp32, the
Bytedance "small" preset cut to 2 layers × 2 heads × 128 on both sides,
``--micro_steps 2 --clustering_vq``, the JAX init); SIGTERM and a
``--resume`` that keeps the clustering statistics and the accumulated
gradients, against the uninterrupted run; the refusals."""

import importlib.util
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(width=128, layers=2, heads=2)
# image 32, patch 8, 8 latent tokens, codebook 64 × 12; bs 4 in two
# micro-batches of 2; three micro-steps an epoch, so an epoch ends between
# the two halves of an update
TINY_ARGS = ["--dataset", "synthetic", "--image_size", "32", "--patch_size",
             "8", "--latent_tokens", "8", "--codebook_size", "64", "--bs",
             "4", "--micro_steps", "2", "--clustering_vq",
             "--steps_per_epoch", "3", "--log_every", "1", "--warmup_steps",
             "2", "--train_steps", "100", "--image_every", "1000",
             "--no_wandb", "--mixed", "false"]
RUN = Path("titok-single-synthetic") / "small_8_64.jsonl"
METRICS = ("train/loss", "train/recon_loss", "train/quant_loss",
           "train/l1_loss", "train/codebook_usage")
# the loop against JAX's: the first three logged steps, then all six
LOOP_REL_FIRST, LOOP_REL_ALL = 1e-3, 1e-2
# The clustering reseed pulls every unused code to within ~1e-3 of its
# nearest input (decay_f = exp(-1e-3)), so after the first update many codes
# are near-ties of each other and either package may pick another of them:
# the losses stay equal, the usage bitmap may count a code more or less.
# Past step 2 the usage is held to USAGE_CODES codes of 64.
USAGE_CODES = 2
JAX_ENTRY = """
import runpy, sys
import jax
jax.config.update("jax_platforms", "cpu")
import vit_tpu.core.config as c
c.BYTEDANCE_WIDTH["small"] = {width}
c.BYTEDANCE_LAYERS["small"] = {layers}
c.BYTEDANCE_HEADS["small"] = {heads}
sys.argv = ["train_tatitok.py", *sys.argv[1:]]
runpy.run_path({script!r}, run_name="__main__")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's small ops run several times
    slower across threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(mp: pytest.MonkeyPatch) -> None:
    import vit_tpu.core.config as jax_config
    import vit_tpu_torch.core.config as torch_config

    for mod in (jax_config, torch_config):
        mp.setitem(mod.BYTEDANCE_WIDTH, "small", SMALL["width"])
        mp.setitem(mod.BYTEDANCE_LAYERS, "small", SMALL["layers"])
        mp.setitem(mod.BYTEDANCE_HEADS, "small", SMALL["heads"])


def _jax_init(monkeypatch: pytest.MonkeyPatch) -> None:
    """The tiny preset in both packages, and the port's entry starting from
    ``train_tatitok.py``'s init: ``TATiTok(cfg).init(PRNGKey(seed),
    zeros((1, image, image, 3)), None, True)``."""
    from vit_tpu.models.tatitok import TATiTok as JaxTATiTok
    from vit_tpu.models.tatitok import TATiTokConfig as JaxConfig
    from vit_tpu_torch import train_tatitok
    from vit_tpu_torch.bridge import tatitok_state_dict_from_flax

    _small(monkeypatch)

    def init(model, generator):
        cfg = model.config
        seed = generator.initial_seed()
        cfg_j = JaxConfig(cfg.image_size, cfg.patch_size, cfg.latent_tokens,
                          cfg.codebook_size, cfg.latent_dim, cfg.transformer,
                          use_l2_norm=cfg.use_l2_norm,
                          clustering_vq=cfg.clustering_vq, dtype=jnp.float32,
                          attn_impl="xla")
        x = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
        params = jax.jit(lambda: JaxTATiTok(cfg_j).init(
            jax.random.PRNGKey(seed), x, None, True))()["params"]
        model.load_state_dict(tatitok_state_dict_from_flax(
            jax.tree.map(np.asarray, params), cfg))

    monkeypatch.setattr(train_tatitok, "init_tatitok_", init)


@pytest.fixture
def jax_init(monkeypatch):
    _jax_init(monkeypatch)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The port's two uninterrupted epochs from the JAX init: (logged
    steps, final state, run directory)."""
    cwd = tmp_path_factory.mktemp("straight")
    with pytest.MonkeyPatch.context() as mp:
        _jax_init(mp)
        logs, state = _port_run(cwd, 2)
    return logs, state, cwd


def _logged(path: Path) -> dict:
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return {r["_step"]: r for r in rows if "train/loss" in r}


def _jax_run(cwd: Path, epochs: int) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONUNBUFFERED="1",
               VIT_TPU_RUN_DIR=str(cwd / "runs"), PYTHONPATH=str(ROOT))
    env.pop("XLA_FLAGS", None)  # one device: no dp mesh over the tiny batch
    code = JAX_ENTRY.format(script=str(ROOT / "train_tatitok.py"), **SMALL)
    proc = subprocess.run(
        [sys.executable, "-c", code, *TINY_ARGS, "--attn_impl", "xla",
         "--epochs", str(epochs), "--ckpt_dir", str(cwd / "ckpt")],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return _logged(cwd / "runs" / RUN)


def _port_run(cwd: Path, epochs: int, *extra: str):
    from vit_tpu_torch.train_tatitok import main

    state = main([*TINY_ARGS, "--device", "cpu", "--epochs", str(epochs),
                  "--ckpt_dir", str(cwd / "ckpt"),
                  "--run_dir", str(cwd / "runs"), *extra])
    return _logged(cwd / "runs" / RUN), state


def test_loop_matches_train_tatitok(tmp_path, straight):
    """Two epochs × three micro-steps of ``train_tatitok.py`` (a subprocess
    on the CPU, ``--attn_impl xla``) and of the port's ``main`` from the same
    init and stream: each logged loss, recon, quantizer and pixel loss and
    the usage within ``LOOP_REL_FIRST`` on the first three steps and
    ``LOOP_REL_ALL`` on all six (the usage past step 2 within
    ``USAGE_CODES``); the epochs equal; "best" and "last" written
    with the clustering statistics in the port's checkpoint."""
    ref = _jax_run(tmp_path, 2)
    got, state, port = straight
    assert sorted(got) == sorted(ref) == [1, 2, 3, 4, 5, 6]
    for step in ref:
        rtol = LOOP_REL_FIRST if step <= 3 else LOOP_REL_ALL
        for k in METRICS:
            if k == "train/codebook_usage" and step > 2:
                assert abs(got[step][k] - ref[step][k]) <= USAGE_CODES / 64
                continue
            np.testing.assert_allclose(got[step][k], ref[step][k], rtol=rtol,
                                       atol=1e-7,
                                       err_msg=f"{k} at step {step}")
        assert got[step]["train/epoch"] == ref[step]["train/epoch"]
    assert state.opt_state.mini_step == 0
    assert int(state.opt_state.inner.count) == 3
    sd = torch.load(port / "ckpt" / "last" / "state.pt", weights_only=True)
    assert set(sd["extra"]) == {"vq_stats"}
    # six EMA updates of a usage that sums to 1, from zero
    np.testing.assert_allclose(
        float(sd["extra"]["vq_stats"]["embed_prob"].sum()), 1 - 0.99 ** 6,
        rtol=1e-5)
    assert (port / "ckpt" / "best" / "state.pt").exists()


def test_sigterm_then_resume_matches_the_straight_run(tmp_path, jax_init,
                                                      straight, monkeypatch,
                                                      capsys):
    """SIGTERM during the second micro-step (inside an accumulation): the
    loop prints PREEMPTED and saves "last" at step 2 with the clustering
    usage EMA, the half-accumulated gradient and the stream position
    (``consumed`` 2); ``--resume`` restores them and its logged metrics at
    steps 3-6 equal the uninterrupted run's. A checkpoint written without
    the ``extra`` tree resumes too, with the statistics from zero."""
    from vit_tpu_torch import train_tatitok

    factory = train_tatitok.make_tatitok_train_step
    calls = [0]

    def make(model, **kw):
        step = factory(model, **kw)

        def counted(*args):
            calls[0] += 1
            if calls[0] == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*args)

        return counted

    monkeypatch.setattr(train_tatitok, "make_tatitok_train_step", make)
    prev = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda *a: None)
    try:
        _, state = _port_run(tmp_path / "cut", 2)
    finally:
        signal.signal(signal.SIGTERM, prev)
    out = capsys.readouterr().out
    assert "PREEMPTED: saving 'last' at step 2 and exiting" in out, out
    assert state.step.item() == 2 and state.opt_state.mini_step == 0
    ckpt = tmp_path / "cut" / "ckpt"
    hist = json.loads((ckpt / "data_state.json").read_text())
    assert hist["2"] == {"epoch": 0, "next_batch": 2, "consumed": 2}
    sd = torch.load(ckpt / "last" / "state.pt", weights_only=True)
    prob = sd["extra"]["vq_stats"]["embed_prob"]
    assert prob.sum() > 0
    monkeypatch.setattr(train_tatitok, "make_tatitok_train_step", factory)
    seen = {}

    def probe(model, **kw):
        seen["prob"] = model.quantize.embed_prob.clone()
        return factory(model, **kw)

    monkeypatch.setattr(train_tatitok, "make_tatitok_train_step", probe)
    resumed, state = _port_run(tmp_path / "cut", 2, "--resume")
    out = capsys.readouterr().out
    assert "RESUMED at step 2" in out and "e=0 s=2 " in out, out
    assert torch.equal(seen["prob"], prob)
    for step in range(3, 7):
        # the usage bitmap starts empty in a resumed run, as in JAX's
        for k in METRICS[:-1]:
            np.testing.assert_allclose(resumed[step][k], straight[0][step][k],
                                       rtol=1e-6, atol=1e-8,
                                       err_msg=f"{k} at step {step}")
    # an older checkpoint: no extra tree
    del sd["extra"]
    torch.save(sd, ckpt / "last" / "state.pt")
    (ckpt / "data_state.json").unlink()
    _port_run(tmp_path / "cut", 1, "--resume")
    out = capsys.readouterr().out
    assert "RESUMED at step 2" in out
    assert torch.equal(seen["prob"], torch.zeros(64))


def test_checkpoint_keeps_the_accumulation():
    """A ``MultiSteps`` state saved half-way through an accumulation and
    loaded into a fresh one: the mean, the micro-step and the inner count
    come back."""
    from vit_tpu_torch.train.optim import MultiSteps, make_optimizer

    params = [torch.ones(3, 2), torch.zeros(4)]
    tx = MultiSteps(make_optimizer(1e-3, 1, 10, 1e-4, 0.0), 3)
    st = tx.init(params)
    tx.update_(params, [torch.full((3, 2), 2.0), torch.ones(4)], st)
    tx.update_(params, [torch.full((3, 2), 4.0), torch.ones(4)], st)
    assert st.mini_step == 2
    torch.testing.assert_close(st.acc[0], torch.full((3, 2), 3.0))
    fresh = tx.init([torch.ones(3, 2), torch.zeros(4)])
    fresh.load_state_dict(st.state_dict(["a", "b"]), ["a", "b"])
    assert fresh.mini_step == 2 and int(fresh.inner.count) == 0
    torch.testing.assert_close(fresh.acc[0], torch.full((3, 2), 3.0))


# -- the flag surface ---------------------------------------------------------

def test_flags_and_defaults_match_train_tatitok(monkeypatch):
    """Every flag ``train_tatitok.py`` takes, with its default (image 256
    at the default imagenet); the port adds ``--device`` only; the image
    size follows ``--dataset``."""
    from vit_tpu_torch.train_tatitok import parse_args

    spec = importlib.util.spec_from_file_location(
        "jax_train_tatitok", ROOT / "train_tatitok.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for argv in ([], ["--dataset", "dmlab"], ["--dataset", "minecraft"],
                 ["--dataset", "synthetic"]):
        monkeypatch.setattr(sys, "argv", ["train_tatitok.py", *argv])
        want = vars(mod.parse_args())
        got = vars(parse_args(argv))
        assert set(got) - set(want) == {"device"}
        assert {k: got[k] for k in want} == want
    assert parse_args([]).image_size == 256


@pytest.mark.parametrize("flags", [
    ["--attn_impl", "xla"], ["--scan_layers", "true"],
    ["--mesh", "1,1,1"], ["--pp_microbatches", "2"],
], ids=lambda f: "_".join(a.lstrip("-") for a in f))
def test_train_tatitok_refuses_unported_flags(flags, tmp_path):
    """Each flag whose path is not ported raises before anything is built
    or written, naming its ROADMAP item."""
    from vit_tpu_torch.train_tatitok import main

    with pytest.raises(NotImplementedError, match="ROADMAP Queue A #"):
        main(["--dataset", "synthetic", *flags, "--device", "cpu",
              "--ckpt_dir", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()


def test_no_card_exits_nonzero(monkeypatch, tmp_path):
    """``--device cuda`` (the default) without a card stops with a message
    before anything is built or written; a real dataset without
    ``--data_dir`` is refused first."""
    from vit_tpu_torch.train_tatitok import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["--dataset", "synthetic", "--ckpt_dir", str(tmp_path / "c"),
              "--run_dir", str(tmp_path / "r")])
    assert "no CUDA device" in str(e.value)
    assert not (tmp_path / "c").exists()
    with pytest.raises(ValueError, match="--data_dir"):
        main(["--dataset", "dmlab", "--device", "cpu"])


def test_ema_decay_is_parsed_and_unused(tmp_path, jax_init, capsys):
    """``--ema_decay`` > 0 prints a warning naming ROADMAP Queue C #9 and
    keeps no average, as ``train_tatitok.py`` builds its state without
    one."""
    _, state = _port_run(tmp_path, 1, "--ema_decay", "0.9",
                         "--steps_per_epoch", "1")
    out = capsys.readouterr().out
    assert "WARNING: --ema_decay 0.9 keeps no average" in out, out
    assert "Queue C #9" in out
    assert state.ema_params is None
    sd = torch.load(tmp_path / "ckpt" / "last" / "state.pt",
                    weights_only=True)
    assert "ema_params" not in sd
