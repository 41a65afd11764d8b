"""Port parity for ``python -m vit_tpu_torch.train_videogpt``: the flag
surface against ``train_videogpt.py:parse_args``, the logged per-step
losses and the generation eval's real strips against ``train_videogpt.py``
run as a subprocess (fp32, a tiny preset on both sides, the same frozen
tokenizer and the JAX init of the prior), ``--resume`` against the
uninterrupted run, SIGTERM, the tokenizer loader (a checkpoint of the
port's ``train_titok`` or ``train_tatitok``, a Bytedance folder, the
refused FSQ kind) and the refusals."""

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
from torch_port_helpers import TINY, tiny_preset

from vit_tpu.models.titok import TiTok as JaxTiTok
from vit_tpu.models.titok import TiTokConfig as JaxTiTokConfig
from vit_tpu.models.videogpt import VideoGPT as JaxVideoGPT
from vit_tpu.models.videogpt import VideoGPTConfig as JaxVideoGPTConfig
from vit_tpu_torch.bridge import (state_dict_from_flax,
                                  videogpt_state_dict_from_flax)
from vit_tpu_torch.models.titok import TiTok, TiTokConfig
from vit_tpu_torch.train.checkpoint import Checkpointer
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState

ROOT = Path(__file__).resolve().parent.parent
# the frozen tokenizer: a tiny TiTok at image 16, 8 codes a frame
TOKENIZER = dict(image_size=16, patch_size=8, latent_tokens=8,
                 codebook_size=32, latent_dim=12, transformer="tiny")
# the prior: 4 frames of 8 codes (S 32), bs 2, fp32, warmup 2
TINY_ARGS = ["--dataset", "synthetic", "--transformer", "tiny",
             "--max_frames", "4", "--condition_frames", "2", "--bs", "2",
             "--steps_per_epoch", "3", "--log_every", "1",
             "--warmup_steps", "2", "--train_steps", "100",
             "--gen_every", "1000", "--no_wandb", "--mixed", "false"]
RUN = Path("videogpt-synthetic") / "8_tiny_32_4frames.jsonl"
# the loop against JAX's: the first three logged steps, then all six
LOOP_REL_FIRST, LOOP_REL_ALL = 1e-3, 1e-2
# the tokenizer's JAX init (train_videogpt.py seeds its random one with 123)
TOKENIZER_SEED = 123
# the JAX entry with the tiny preset registered, on the CPU, one device
JAX_ENTRY = """
import runpy, sys
import jax
jax.config.update("jax_platforms", "cpu")
import vit_tpu.core.config as c
c.transformer_configs["tiny"] = lambda **kw: c.TransformerConfig(
    n_layers={n_layers}, n_heads={n_heads}, n_embd={n_embd}, **kw)
sys.argv = ["train_videogpt.py", *sys.argv[1:]]
runpy.run_path({script!r}, run_name="__main__")
"""


def _jax_tokenizer_config():
    return JaxTiTokConfig(**TOKENIZER, dtype=jnp.float32, attn_impl="xla")


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    """The tiny TiTok's JAX init saved twice as "best": by the JAX
    checkpointer (for ``train_videogpt.py``) and by the port's (for the
    port's entry)."""
    from vit_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
    from vit_tpu.train.optim import make_optimizer as jax_make_optimizer
    from vit_tpu.train.state import TrainState as JaxTrainState

    root = tmp_path_factory.mktemp("tokenizers")
    with tiny_preset():
        cfg_j = _jax_tokenizer_config()
        params = jax.jit(JaxTiTok(cfg_j).init)(
            jax.random.PRNGKey(TOKENIZER_SEED),
            jnp.zeros((1, 16, 16, 3)))["params"]
        tx = jax_make_optimizer(1e-4, 1, 10, 1e-5, 0.0)
        ckpt = JaxCheckpointer(str(root / "jax"))
        ckpt.save(JaxTrainState.create(params, tx), config=cfg_j, tag="best")
        ckpt.finalize()
        cfg_t = TiTokConfig(**TOKENIZER, dtype=torch.float32)
        model = TiTok(cfg_t, device="meta")
        model.load_state_dict(state_dict_from_flax(
            jax.tree.map(np.asarray, params), cfg_t), assign=True)
        Checkpointer(str(root / "port")).save(
            TrainState.create(model, make_optimizer(1e-4, 1, 10, 1e-5, 0.0)),
            config=cfg_t, tag="best")
    return root / "jax", root / "port"


@pytest.fixture
def jax_prior_init(monkeypatch):
    """The port's entry starts the prior from JAX's
    ``VideoGPT(cfg).init(PRNGKey(seed), zeros((1, max_frames,
    frame_size)))``, with the tiny preset registered for the run."""
    from vit_tpu_torch import train_videogpt

    cache = {}

    def init(model, seed):
        cfg = model.config
        key = (seed, cfg.frame_size, cfg.codebook_size, cfg.max_frames)
        if key not in cache:
            cfg_j = JaxVideoGPTConfig(cfg.frame_size, cfg.codebook_size,
                                      cfg.transformer, cfg.max_frames,
                                      dtype=jnp.float32, attn_impl="xla")
            x = jnp.zeros((1, cfg.max_frames, cfg.frame_size), jnp.int32)
            cache[key] = jax.tree.map(np.asarray, jax.jit(
                JaxVideoGPT(cfg_j).init)(jax.random.PRNGKey(seed), x)[
                    "params"])
        model.load_state_dict(videogpt_state_dict_from_flax(cache[key], cfg))

    monkeypatch.setattr(train_videogpt, "init_weights", init)
    with tiny_preset():
        yield


def _logged(path: Path) -> dict:
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return {r["_step"]: r for r in rows if "train/loss" in r}


def _jax_run(cwd: Path, tokenizer: Path, epochs: int, *extra: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONUNBUFFERED="1",
               VIT_TPU_RUN_DIR=str(cwd / "runs"), PYTHONPATH=str(ROOT))
    env.pop("XLA_FLAGS", None)  # one device: no dp mesh over the tiny batch
    code = JAX_ENTRY.format(script=str(ROOT / "train_videogpt.py"), **TINY)
    proc = subprocess.run(
        [sys.executable, "-c", code, *TINY_ARGS, "--attn_impl", "xla",
         "--tokenizer_ckpt", str(tokenizer), "--epochs", str(epochs),
         "--ckpt_dir", str(cwd / "ckpt"), *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return _logged(cwd / "runs" / RUN)


def _port_run(cwd: Path, tokenizer: Path, epochs: int, *extra: str):
    from vit_tpu_torch.train_videogpt import main

    state = main([*TINY_ARGS, "--device", "cpu", "--tokenizer_ckpt",
                  str(tokenizer), "--epochs", str(epochs),
                  "--ckpt_dir", str(cwd / "ckpt"),
                  "--run_dir", str(cwd / "runs"), *extra])
    return _logged(cwd / "runs" / RUN), state


def _pngs(cwd: Path) -> dict:
    from PIL import Image

    folder = (cwd / "runs" / RUN).with_name(RUN.stem + "_images")
    return {p.name: np.asarray(Image.open(p)) for p in folder.iterdir()}


def test_loop_matches_train_videogpt(tmp_path, tokenizer_dirs,
                                     jax_prior_init):
    """Two epochs × three steps of ``train_videogpt.py`` (a subprocess on
    the CPU, ``--attn_impl xla``) and of the port's ``main`` over the same
    frozen tokenizer, prior init, stream and crops: each logged loss within
    ``LOOP_REL_FIRST`` on the first three steps and ``LOOP_REL_ALL`` on all
    six, the same epoch and step counts. The step-0 generation eval writes
    each side's real and generated strips: the real ones (the crops)
    equal, the generated ones of the same shape, their conditioning
    frames (the real codes, decoded) within one 8-bit level."""
    jax_tok, port_tok = tokenizer_dirs
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = _jax_run(tmp_path / "jax", jax_tok, 2)
    got, _ = _port_run(tmp_path / "port", port_tok, 2)
    assert sorted(got) == sorted(ref) == [1, 2, 3, 4, 5, 6]
    for step in ref:
        rtol = LOOP_REL_FIRST if step <= 3 else LOOP_REL_ALL
        np.testing.assert_allclose(got[step]["train/loss"],
                                   ref[step]["train/loss"], rtol=rtol,
                                   err_msg=f"loss at step {step}")
        for k in ("train/epoch", "train/steps"):
            assert got[step][k] == ref[step][k], (k, step)
    pngs = {side: _pngs(tmp_path / side) for side in ("jax", "port")}
    assert sorted(pngs["port"]) == sorted(pngs["jax"]) == [
        "gen_video_1_0.png", "gen_video_1_1.png", "video_1_0.png",
        "video_1_1.png"]
    for name, img in pngs["port"].items():
        assert img.shape == pngs["jax"][name].shape == (16, 4 * 16, 3), name
        if name.startswith("video"):
            np.testing.assert_array_equal(img, pngs["jax"][name])
        else:
            cond = slice(0, 2 * 16)
            diff = np.abs(img[:, cond].astype(int)
                          - pngs["jax"][name][:, cond].astype(int))
            assert diff.max() <= 1, name


def test_resume_replays_losses_and_crops(tmp_path, tokenizer_dirs,
                                         jax_prior_init, capsys):
    """Two epochs straight against one epoch, then ``--resume`` for the
    second: "RESUMED" at step 3 with the stream position and the crop
    count (``consumed`` 3), and the same losses on steps 4-6, which differ
    unless the crops do not."""
    _, port_tok = tokenizer_dirs
    straight, _ = _port_run(tmp_path / "a", port_tok, 2)
    _port_run(tmp_path / "b", port_tok, 1)
    hist = json.loads((tmp_path / "b" / "ckpt" / "data_state.json")
                      .read_text())
    assert hist["3"] == {"epoch": 1, "next_batch": 0, "consumed": 3}
    capsys.readouterr()
    resumed, state = _port_run(tmp_path / "b", port_tok, 2, "--resume")
    out = capsys.readouterr().out
    assert "RESUMED at step 3" in out, out
    assert "RESUMED data stream at epoch 1, batch 0" in out, out
    assert state.step.item() == 6
    for s in (4, 5, 6):
        np.testing.assert_allclose(resumed[s]["train/loss"],
                                   straight[s]["train/loss"], rtol=1e-6)
        assert resumed[s]["train/steps"] == straight[s]["train/steps"]
    assert len({straight[s]["train/loss"] for s in (1, 4)}) == 2


def test_sigterm_saves_last_and_exits(tmp_path, tokenizer_dirs,
                                      jax_prior_init, monkeypatch, capsys):
    """SIGTERM to the process during the third step: the loop finishes the
    step, prints PREEMPTED, saves "last" at step 3 with the stream position
    (``consumed`` 3) and returns; ``--resume`` continues at step 3."""
    from vit_tpu_torch import train_videogpt

    _, port_tok = tokenizer_dirs
    factory = train_videogpt.make_videogpt_train_step
    calls = [0]

    def make(model):
        step = factory(model)

        def counted(*args):
            calls[0] += 1
            if calls[0] == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*args)

        return counted

    monkeypatch.setattr(train_videogpt, "make_videogpt_train_step", make)
    prev = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda *a: None)
    try:
        _, state = _port_run(tmp_path, port_tok, 1, "--steps_per_epoch",
                             "100000")
    finally:
        signal.signal(signal.SIGTERM, prev)
    out = capsys.readouterr().out
    assert "PREEMPTED: saving 'last' at step 3 and exiting" in out, out
    assert state.step.item() == 3
    meta = json.loads((tmp_path / "ckpt" / "last_meta.json").read_text())
    assert meta["step"] == 3
    hist = json.loads((tmp_path / "ckpt" / "data_state.json").read_text())
    assert hist["3"] == {"epoch": 0, "next_batch": 3, "consumed": 3}
    monkeypatch.setattr(train_videogpt, "make_videogpt_train_step", factory)
    _, state = _port_run(tmp_path, port_tok, 1, "--steps_per_epoch", "5",
                         "--resume")
    out = capsys.readouterr().out
    assert "RESUMED at step 3" in out and "e=0 s=3 " in out, out
    assert state.step.item() == 5


def test_dropout_warns_of_the_reference_divergence(tmp_path, tokenizer_dirs,
                                                   jax_prior_init, capsys):
    """``--dropout 0.5`` prints the warning that ``train_videogpt.py``
    ignores the flag in training, and trains with dropout: the logged
    losses differ from the ``--dropout 0`` run's on the same init, stream
    and crops (no dropout run prints no warning)."""
    _, port_tok = tokenizer_dirs
    plain, _ = _port_run(tmp_path / "a", port_tok, 1)
    out = capsys.readouterr().out
    assert "WARNING: --dropout" not in out, out
    dropped, _ = _port_run(tmp_path / "b", port_tok, 1, "--dropout", "0.5")
    out = capsys.readouterr().out
    assert ("WARNING: --dropout 0.5 trains the prior with dropout; "
            "train_videogpt.py's step runs deterministic") in out, out
    assert sorted(dropped) == sorted(plain) == [1, 2, 3]
    for s in dropped:
        assert np.isfinite(dropped[s]["train/loss"])
        assert dropped[s]["train/loss"] != plain[s]["train/loss"], s


def test_train_titok_checkpoint_loads_as_frozen_tokenizer(tmp_path):
    """A checkpoint directory the port's ``train_titok`` wrote (tiny
    preset, fp32, two steps) is a ``--tokenizer_ckpt``: its "best"
    weights, its token count, codebook and image size, frozen; its codes
    equal those of the model rebuilt from ``load_params``; the entry
    trains one step over it and writes the step-0 PNGs."""
    from vit_tpu_torch.models.pretrained import load_tokenizer
    from vit_tpu_torch.train.checkpoint import load_params
    from vit_tpu_torch.train_titok import main as titok_main
    from vit_tpu_torch.train_videogpt import main as videogpt_main

    with tiny_preset():
        titok_main(["--dataset", "synthetic", "--transformer", "tiny",
                    "--image_size", "16", "--patch_size", "8",
                    "--latent_tokens", "4", "--codebook_size", "16",
                    "--bs", "2", "--epochs", "1", "--steps_per_epoch", "2",
                    "--log_every", "1", "--mixed", "false", "--no_wandb",
                    "--device", "cpu", "--ckpt_dir", str(tmp_path / "tok"),
                    "--run_dir", str(tmp_path / "runs")])
        tok = load_tokenizer(str(tmp_path / "tok"), torch.float32, "cpu")
        assert (tok.latent_tokens, tok.codebook_size, tok.image_size) == (
            4, 16, 16)
        assert not tok.model.training
        assert not any(p.requires_grad for p in tok.model.parameters())
        ref = TiTok(tok.model.config)
        ref.load_state_dict(load_params(str(tmp_path / "tok"), "best"))
        frames = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 1, (3, 16, 16, 3)).astype(np.float32))
        codes = tok.encode_indices(frames)
        assert codes.shape == (3, 4) and codes.dtype == torch.int32
        with torch.no_grad():
            assert torch.equal(codes, ref.encode(frames))
        assert tok.decode_indices(codes).shape == (3, 16, 16, 3)
        state = videogpt_main([
            "--dataset", "synthetic", "--tokenizer_ckpt",
            str(tmp_path / "tok"), "--transformer", "tiny", "--max_frames",
            "3", "--condition_frames", "1", "--bs", "2", "--epochs", "1",
            "--steps_per_epoch", "1", "--log_every", "1", "--no_wandb",
            "--mixed", "false", "--device", "cpu", "--ckpt_dir",
            str(tmp_path / "gpt"), "--run_dir", str(tmp_path / "runs")])
    assert state.step.item() == 1
    assert state.params[0].shape[0] == 16 + 1   # tok_embed: codes + SOS
    images = sorted(p.name for p in (tmp_path / "runs" / "videogpt-synthetic"
                                     / "4_tiny_16_3frames_images").iterdir())
    assert images == ["gen_video_1_0.png", "gen_video_1_1.png",
                      "video_1_0.png", "video_1_1.png"]


@pytest.mark.parametrize("kind", ["fsq"])
def test_load_tokenizer_refuses_unported_kinds(tmp_path, kind):
    """An FSQ tokenizer, whose codes range over prod(levels) and not the
    prior's vocabulary, is refused naming Queue C."""
    from vit_tpu_torch.models.pretrained import load_tokenizer
    from vit_tpu_torch.train.checkpoint import _config_to_dict

    cfg = TiTokConfig(16, 8, 4, 32, 12, "S", quantizer=kind)
    (tmp_path / "best_config.json").write_text(json.dumps(
        _config_to_dict(cfg)))
    with pytest.raises(NotImplementedError, match="Queue C"):
        load_tokenizer(str(tmp_path), torch.float32, "cpu")


# a TATiTok tokenizer: the Bytedance "small" preset cut to 2 layers × 2
# heads × 128, image 16, patch 8, 4 codes a frame, codebook 16
TATITOK_SMALL = dict(width=128, layers=2, heads=2)
TATITOK_ARGS = ["--dataset", "synthetic", "--image_size", "16",
                "--patch_size", "8", "--latent_tokens", "4",
                "--codebook_size", "16", "--bs", "2", "--epochs", "1",
                "--steps_per_epoch", "1", "--log_every", "1", "--mixed",
                "false", "--no_wandb", "--device", "cpu"]


@pytest.mark.parametrize("kind", ["port_dir", "bytedance"])
def test_load_tokenizer_reads_tatitok(tmp_path, monkeypatch, kind):
    """A TATiTok ``--tokenizer_ckpt``: a directory the port's
    ``train_tatitok`` wrote (one step) or a Bytedance folder
    (``config.yaml`` + ``pytorch_model.bin``) written from a port TATiTok.
    The loaded tokenizer is frozen, sets the token count, codebook and
    image size, and its codes and decoded images equal JAX's
    ``FrozenTokenizer`` over the same weights (for the Bytedance folder,
    ``get_titok_tokenizer``'s); the entry trains one step over it."""
    import vit_tpu.core.config as jax_config
    import vit_tpu_torch.core.config as torch_config
    from vit_tpu.models.pretrained import FrozenTokenizer as JaxFrozen
    from vit_tpu.models.pretrained import get_titok_tokenizer
    from vit_tpu.models.tatitok import TATiTok as JaxTATiTok
    from vit_tpu.models.tatitok import TATiTokConfig as JaxTATiTokConfig
    from vit_tpu_torch.bridge import flax_from_state_dict
    from vit_tpu_torch.models.pretrained import (load_tokenizer,
                                                 write_bytedance_folder)
    from vit_tpu_torch.models.tatitok import TATiTok, TATiTokConfig
    from vit_tpu_torch.train.checkpoint import load_params
    from vit_tpu_torch.train_tatitok import main as tatitok_main
    from vit_tpu_torch.train_videogpt import main as videogpt_main
    from vit_tpu_torch.utils.init import init_tatitok_

    for mod in (jax_config, torch_config):
        monkeypatch.setitem(mod.BYTEDANCE_WIDTH, "small",
                            TATITOK_SMALL["width"])
        monkeypatch.setitem(mod.BYTEDANCE_LAYERS, "small",
                            TATITOK_SMALL["layers"])
        monkeypatch.setitem(mod.BYTEDANCE_HEADS, "small",
                            TATITOK_SMALL["heads"])
    ckpt = tmp_path / "tok"
    if kind == "port_dir":
        tatitok_main([*TATITOK_ARGS, "--ckpt_dir", str(ckpt), "--run_dir",
                      str(tmp_path / "runs")])
        cfg_j = JaxTATiTokConfig(16, 8, 4, 16, 12, "small",
                                 dtype=jnp.float32, attn_impl="xla")
        params = flax_from_state_dict(load_params(str(ckpt), "best"))
        tok_j = JaxFrozen(JaxTATiTok(cfg_j), jax.tree.map(jnp.asarray,
                                                         params))
    else:
        model = TATiTok(TATiTokConfig(16, 8, 4, 16, 12, "small"))
        init_tatitok_(model, torch.Generator().manual_seed(3))
        write_bytedance_folder(model, ckpt)
        tok_j = JaxFrozen(*get_titok_tokenizer(str(ckpt)))
    tok = load_tokenizer(str(ckpt), torch.bfloat16, "cpu")
    assert isinstance(tok.model, TATiTok)
    assert tok.model.config.dtype == torch.float32
    assert (tok.latent_tokens, tok.codebook_size, tok.image_size) == (
        4, 16, 16)
    assert not tok.model.training
    assert not any(p.requires_grad for p in tok.model.parameters())
    frames = np.random.default_rng(0).uniform(0, 1, (6, 16, 16, 3)).astype(
        np.float32)
    codes = tok.encode_indices(torch.from_numpy(frames))
    assert codes.shape == (6, 4) and codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(tok_j.encode_indices(frames)))
    np.testing.assert_allclose(
        tok.decode_indices(codes).numpy(),
        np.asarray(tok_j.decode_indices(codes.numpy())), rtol=0, atol=1e-5)
    with tiny_preset():
        state = videogpt_main([
            "--dataset", "synthetic", "--tokenizer_ckpt", str(ckpt),
            "--transformer", "tiny", "--max_frames", "3",
            "--condition_frames", "1", "--bs", "2", "--epochs", "1",
            "--steps_per_epoch", "1", "--log_every", "1", "--no_wandb",
            "--mixed", "false", "--device", "cpu", "--ckpt_dir",
            str(tmp_path / "gpt"), "--run_dir", str(tmp_path / "runs")])
    assert state.step.item() == 1
    assert state.params[0].shape[0] == 16 + 1   # tok_embed: codes + SOS


def test_random_tokenizer_is_titok_s_from_a_fixed_seed():
    """``--tokenizer_ckpt random``: ``TiTokConfig(image_size, 8,
    frame_size, codebook_size, 12, "S")`` in the compute dtype, the same
    weights on every call."""
    from vit_tpu_torch.models.pretrained import load_tokenizer

    a = load_tokenizer("random", torch.bfloat16, "cpu", image_size=16,
                       frame_size=4, codebook_size=32)
    b = load_tokenizer("random", torch.bfloat16, "cpu", image_size=16,
                       frame_size=4, codebook_size=32)
    cfg = a.model.config
    assert (cfg.image_size, cfg.patch_size, cfg.latent_tokens,
            cfg.codebook_size, cfg.latent_dim, cfg.transformer, cfg.dtype) == (
        16, 8, 4, 32, 12, "S", torch.bfloat16)
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                 b.model.parameters()))


# -- the flag surface ---------------------------------------------------------

def test_flags_and_defaults_match_train_videogpt(monkeypatch):
    """Every flag ``train_videogpt.py`` takes, with its default; the port
    adds ``--device`` only."""
    from vit_tpu_torch.train_videogpt import parse_args

    spec = importlib.util.spec_from_file_location(
        "jax_train_videogpt", ROOT / "train_videogpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["train_videogpt.py"])
    want = vars(mod.parse_args())
    got = vars(parse_args([]))
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    assert got["min_lr"] == got["lr"] / 10
    with pytest.raises(SystemExit):
        parse_args(["--condition_frames", "16"])


@pytest.mark.parametrize("flags", [
    ["--attn_impl", "xla"],
    ["--scan_layers", "true"], ["--mesh", "1,1,1"],
    ["--pp_microbatches", "2"],
], ids=lambda f: "_".join(a.lstrip("-") for a in f))
def test_train_videogpt_refuses_unported_flags(flags, tmp_path):
    """Each flag whose path is not ported raises before anything is built
    or written, naming its ROADMAP item."""
    from vit_tpu_torch.train_videogpt import main

    base = [] if flags[:1] == ["--dataset"] else ["--dataset", "synthetic"]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A #"):
        main(base + flags + ["--device", "cpu", "--ckpt_dir",
                             str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()


def test_no_card_exits_nonzero(monkeypatch, tmp_path):
    """``--device cuda`` (the default) without a card stops with a message
    before anything is built or written."""
    from vit_tpu_torch.train_videogpt import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["--dataset", "synthetic", "--ckpt_dir", str(tmp_path / "c"),
              "--run_dir", str(tmp_path / "r")])
    assert e.value.code not in (0, None) and "no CUDA device" in str(
        e.value.code)
    assert not (tmp_path / "c").exists() and not (tmp_path / "r").exists()
