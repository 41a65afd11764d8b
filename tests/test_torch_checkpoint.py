"""Port parity for the checkpointer (``vit_tpu_torch/train/checkpoint.py``):
the train state's round trip bit for bit, "best" gating against the JAX
``Checkpointer``'s decisions, crash safety of a tag, the stream-position
history against JAX's, and the config files."""

import json

import numpy as np
import pytest
import torch

from vit_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from vit_tpu_torch.models.titok import TiTok, TiTokConfig
from vit_tpu_torch.train.checkpoint import Checkpointer, load_params
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState
from vit_tpu_torch.train.step import make_tokenizer_train_step
from vit_tpu_torch.utils.config import dataclass_from_dict
from vit_tpu_torch.utils.init import init_params_

METRICS = [0.5, 0.7, 0.4, 0.4, 0.45, 0.2, 0.9, 0.1]


def _tiny_state(seed: int, steps: int = 0):
    """A 2-layer TiTok-S at image 16, its state after ``steps`` fp32 train
    steps with a bf16 first moment, and the step."""
    cfg = TiTokConfig(16, 8, 4, 32, 12, "S", dtype=torch.float32)
    for name in ("enc_vit_config", "dec_vit_config"):
        sub = getattr(cfg, name)
        sub.trans_config = sub.trans_config.replace(n_layers=2)
    model = TiTok(cfg)
    init_params_(model, torch.Generator().manual_seed(seed))
    model.train().requires_grad_(True)
    state = TrainState.create(model, make_optimizer(
        1e-3, 1, 100, 1e-4, 1e-4, clip_norm=1.0, mu_dtype="bfloat16"))
    step = make_tokenizer_train_step(model)
    usage = torch.zeros(32)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        images = torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 3))
                                  .astype(np.float32))
        step(state, images, usage)
    return cfg, state, step


def _flat(state: TrainState) -> dict:
    sd = state.state_dict()
    out = {"step": sd["step"], "count": sd["opt_state"]["count"]}
    for group in ("params",):
        out.update({f"params/{k}": v for k, v in sd[group].items()})
    for group in ("mu", "nu"):
        out.update({f"{group}/{k}": v for k, v in
                    sd["opt_state"][group].items()})
    return out


def test_round_trip_is_bit_for_bit(tmp_path):
    """Save after three steps, restore into a state of other weights: every
    tensor equal bit for bit, in its dtype (μ bf16, ν fp32), the step and
    the count too; the restored state trains on as the saved one."""
    cfg, state, step = _tiny_state(0, steps=3)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(state, config=cfg, tag="last")
    _, other, other_step = _tiny_state(1)
    assert ckpt.can_restore() and not ckpt.can_restore("best")
    Checkpointer(str(tmp_path)).restore(other)
    want, got = _flat(state), _flat(other)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert other.step.item() == 3 and other.opt_state.count.item() == 3
    assert {t.dtype for t in other.opt_state.mu} == {torch.bfloat16}
    images = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 1, (2, 16, 16, 3)).astype(np.float32))
    step(state, images, torch.zeros(32))
    other_step(other, images, torch.zeros(32))
    assert all(torch.equal(a, b) for a, b in zip(other.params, state.params))
    params = load_params(str(tmp_path))
    assert list(params) == other.names
    meta = json.loads((tmp_path / "last_meta.json").read_text())
    assert meta == {"best": None, "step": 3}
    rebuilt = dataclass_from_dict(TiTokConfig, json.loads(
        (tmp_path / "last_config.json").read_text()))
    assert (rebuilt.image_size, rebuilt.dtype, rebuilt.n_embd) == \
        (16, torch.float32, 512)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_best_gating_matches_jax(tmp_path, mode, monkeypatch):
    """The same metric sequence gives the same saves of "best" (and the
    same ``best``) as the JAX ``Checkpointer``, whose writes are recorded
    instead of made."""
    _, state, _ = _tiny_state(0)
    ref = JaxCheckpointer(str(tmp_path / "jax"), mode=mode)
    ref_saves = []
    monkeypatch.setattr(ref, "save", lambda st, **kw: ref_saves.append(
        (kw["tag"], ref.best)))
    port = Checkpointer(str(tmp_path / "port"), mode=mode)
    for i, metric in enumerate(METRICS):
        state.step.fill_(i)
        assert port.save_if_best(state, metric) == \
            ref.save_if_best(None, metric)
        assert port.best == ref.best
    best = json.loads((tmp_path / "port" / "best_meta.json").read_text())
    assert best == {"best": ref_saves[-1][1],
                    "step": max(i for i, m in enumerate(METRICS)
                                if m == ref_saves[-1][1])}
    assert len(ref_saves) == (4 if mode == "min" else 3)
    # a restore carries the best metric of the tag's meta
    again = Checkpointer(str(tmp_path / "port"), mode=mode)
    again.restore(state, tag="best")
    assert again.best == ref.best


def test_stale_tmp_leaves_previous_tag_restorable(tmp_path):
    """A save that crashed while writing leaves ``.last.tmp``: the old
    "last" restores unchanged, and the next save replaces the stale
    directory."""
    _, state, _ = _tiny_state(0, steps=1)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(state, tag="last")
    saved = {k: v.clone() for k, v in _flat(state).items()}
    stale = tmp_path / ".last.tmp"
    stale.mkdir()
    (stale / "state.pt").write_bytes(b"half a file")
    _, other, _ = _tiny_state(2)
    fresh = Checkpointer(str(tmp_path))
    assert fresh.can_restore()
    fresh.restore(other)
    assert all(torch.equal(_flat(other)[k], v) for k, v in saved.items())
    other.step.fill_(7)
    fresh.save(other, tag="last")
    assert not stale.exists()
    assert json.loads((tmp_path / "last_meta.json").read_text())["step"] == 7
    assert sorted(p.name for p in tmp_path.iterdir()) == ["last",
                                                          "last_meta.json"]


def test_data_state_history_matches_jax(tmp_path):
    """``keep=8``: the same history file, and for each step the entry at or
    before it, as the JAX checkpointer gives."""
    ref = JaxCheckpointer(str(tmp_path / "jax"))
    port = Checkpointer(str(tmp_path / "port"))
    assert port.load_data_state(100) is None is ref.load_data_state(100)
    for step in range(1, 12):
        entry = {"epoch": step // 5, "next_batch": step % 5}
        ref.save_data_state(step, entry, keep=8)
        port.save_data_state(step, entry, keep=8)
    assert json.loads((tmp_path / "port" / "data_state.json").read_text()) \
        == json.loads((tmp_path / "jax" / "data_state.json").read_text())
    for step in (0, 2, 3, 4, 8, 11, 12, 10 ** 9):
        assert port.load_data_state(step) == ref.load_data_state(step)
