"""Shared set-up of the tokenizer-loop tests (``tests/test_torch_loop*.py``):
the tiny ``train_titok`` config (fp32), its JAX init, runs of
``train_titok.py`` as a subprocess and of the port's ``main``, and their
logged steps."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.models.titok import TiTok as JaxTiTok
from vit_tpu.models.titok import TiTokConfig as JaxTiTokConfig
from vit_tpu_torch.bridge import state_dict_from_flax
from vit_tpu_torch.models.titok import TiTokConfig

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
# the weight average after the loop's three steps, against JAX's
EMA_REL = 1e-6


def tiny_jax_params():
    cfg = JaxTiTokConfig(16, 8, 4, 32, 12, "S", dtype=jnp.float32)
    for name in ("enc_vit_config", "dec_vit_config"):
        sub = getattr(cfg, name)
        sub.trans_config = sub.trans_config.replace(n_layers=2)
    params = jax.jit(JaxTiTok(cfg).init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 16, 16, 3)))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny_params():
    return tiny_jax_params()


def tiny_port_config():
    cfg = TiTokConfig(16, 8, 4, 32, 12, "S", dtype=torch.float32)
    for name in ("enc_vit_config", "dec_vit_config"):
        sub = getattr(cfg, name)
        sub.trans_config = sub.trans_config.replace(n_layers=2)
    return cfg


def jax_run(cwd: Path, epochs: int, *extra: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONUNBUFFERED="1",
               VIT_TPU_RUN_DIR=str(cwd / "runs"))
    env.pop("XLA_FLAGS", None)  # one device: no dp mesh over the tiny batch
    proc = subprocess.run(
        [sys.executable, str(ROOT / "train_titok.py"), *TINY,
         "--epochs", str(epochs), "--ckpt_dir", str(cwd / "ckpt"), *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return logged(cwd / "runs" / RUN)


def logged(path: Path) -> dict:
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return {r["_step"]: r for r in rows if "train/loss" in r}


def port_run(cwd: Path, epochs: int, *extra: str) -> dict:
    from vit_tpu_torch.train_titok import main

    main([*TINY, "--device", "cpu", "--epochs", str(epochs),
          "--ckpt_dir", str(cwd / "ckpt"), "--run_dir", str(cwd / "runs"),
          *extra])
    return logged(cwd / "runs" / RUN)


@pytest.fixture
def jax_init(monkeypatch, tiny_params):
    """The port's loop starts from JAX's ``TiTok(cfg).init(PRNGKey(0))``."""
    from vit_tpu_torch.train import loop

    def init(model, seed):
        assert seed == 0
        model.load_state_dict(state_dict_from_flax(tiny_params,
                                                   model.config))

    monkeypatch.setattr(loop, "init_weights", init)
