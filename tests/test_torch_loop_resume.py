"""Port parity for the tokenizer loop's resume paths
(``python -m vit_tpu_torch.train_titok``): ``--resume`` against the
uninterrupted run, and SIGTERM → "last" → ``--resume`` in a subprocess.
Moved whole from ``test_torch_loop.py``, whose one xdist worker set the
suite's wall time."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from torch_loop_helpers import ROOT, port_run


def test_resume_matches_uninterrupted_run(tmp_path, capsys):
    """Two epochs straight against one epoch, then ``--resume`` for the
    second: the same batches and the same losses (the counterpart of
    ``test_e2e_resume_matches_uninterrupted_run``)."""
    straight = port_run(tmp_path / "a", 2)
    port_run(tmp_path / "b", 1)
    capsys.readouterr()
    resumed = port_run(tmp_path / "b", 2, "--resume")
    out = capsys.readouterr().out
    assert "RESUMED at step 3" in out, out
    assert "RESUMED data stream at epoch 1, batch 0" in out, out
    second = [s for s in straight if s > 3]
    assert second == [4, 5, 6]
    for s in second:
        for k in ("train/loss", "train/recon_loss"):
            np.testing.assert_allclose(resumed[s][k], straight[s][k],
                                       rtol=1e-6)


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
