"""Checkpoints with best-metric gating and full resume (counterpart of
``vit_tpu/train/checkpoint.py:45-268``).

A tag ("best", "last") is a directory ``<dir>/<tag>/`` holding
``state.pt``: ``torch.save`` of the train state's ``state_dict`` on the
host (the step, the parameters by the model's own names, the optimizer's
count, μ in its own dtype and ν, and, only when ``--ema_decay`` is on, the
weight average ``ema_params``), read back with ``torch.load(...,
weights_only=True)``. A restore into a state with EMA from a checkpoint
without it seeds the average from the restored parameters, and a state
without EMA drops a saved one (``TrainState.load_state_dict``), as the JAX
checkpointer does. A save may carry an ``extra`` tree of tensors besides
the state (TATiTok's clustering usage, ``{"vq_stats": {"embed_prob":
...}}``), kept under ``"extra"`` in ``state.pt``; a restore given live
tensors of the same tree copies it into them and returns it beside the
state, or None from a checkpoint written without one
(``vit_tpu/train/checkpoint.py``'s ``extra``/``extra_template``). Beside
it, as in the JAX package, ``<tag>_config.json``
(the model config) and ``<tag>_meta.json`` (``{"best", "step"}``), and
``data_state.json``, the input-stream position by step.

Saves are synchronous: the state is copied to the host and written before
``save`` returns. They are crash-safe: a save writes ``.<tag>.tmp/``, syncs
it to disk, and only then swaps it in for the old tag, which stays on disk
until the new one is complete. A crash at any point leaves a restorable
tag, and a stale ``.<tag>.tmp`` is removed by the next save.

In a ``torch.distributed`` job of more than one process, rank 0 writes and
every rank reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from vit_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


def _config_to_dict(config) -> Dict[str, Any]:
    if dataclasses.is_dataclass(config):
        out = {}
        for f in dataclasses.fields(config):
            v = getattr(config, f.name)
            out[f.name] = (_config_to_dict(v) if dataclasses.is_dataclass(v)
                           else _jsonable(v))
        # derived attributes set in __post_init__
        for k, v in vars(config).items():
            if k not in out:
                out[k] = (_config_to_dict(v) if dataclasses.is_dataclass(v)
                          else _jsonable(v))
        return out
    return _jsonable(config)


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


def _writer() -> bool:
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def _write_json(path: Path, obj) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj, indent=2))
    tmp.replace(path)


def _host(tree):
    """Nested dicts of tensors → the same on the host (a copy of each
    tensor that lives on a device)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu()


@torch.no_grad()
def _copy_tree(dst, src, what: str) -> None:
    """Copy the nested dict ``src`` into the live tensors of ``dst``."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise KeyError(f"{what}: saved keys {sorted(src)} are not "
                           f"{sorted(dst)}")
        for k in dst:
            _copy_tree(dst[k], src[k], f"{what}/{k}")
        return
    if src.shape != dst.shape:
        raise ValueError(f"{what}: saved shape {tuple(src.shape)}, want "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


class Checkpointer:
    """Best-metric-gated checkpoint writer and resume reader."""

    def __init__(self, directory: str, *, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', not {mode!r}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.mode = mode
        self.best: Optional[float] = None

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        return metric < self.best if self.mode == "min" else metric > self.best

    def save_if_best(self, state: TrainState, metric: float,
                     config=None, extra: Optional[dict] = None) -> bool:
        if not self._improved(metric):
            return False
        self.best = float(metric)
        self.save(state, config=config, tag="best", extra=extra)
        return True

    def _swap(self, tmp: Path, final: Path) -> None:
        """Put the complete ``tmp`` in ``final``'s place; the old tag is
        removed only after the rename."""
        old = final.with_name(final.name + ".old")
        if old.exists():
            shutil.rmtree(old)
        if final.exists():
            final.rename(old)
        tmp.rename(final)
        if old.exists():
            shutil.rmtree(old)

    def save(self, state: TrainState, *, config=None, tag: str = "last",
             extra: Optional[dict] = None):
        """Write ``state`` (and ``extra``) under ``tag`` (synchronously,
        crash-safe)."""
        sd = _host(state.state_dict())
        if extra:
            sd["extra"] = _host(extra)
        if not _writer():
            return
        tmp = self.directory / f".{tag}.tmp"
        if tmp.exists():  # stale, from a save that crashed
            shutil.rmtree(tmp)
        tmp.mkdir()
        with open(tmp / STATE_FILE, "wb") as f:
            torch.save(sd, f)
            f.flush()
            os.fsync(f.fileno())
        self._swap(tmp, self.directory / tag)
        if config is not None:
            _write_json(self.directory / f"{tag}_config.json",
                        _config_to_dict(config))
        _write_json(self.directory / f"{tag}_meta.json",
                    {"best": self.best, "step": int(sd["step"])})

    def finalize(self):
        """Nothing to wait for: every save is on disk when it returns. Kept
        so that the loops end as the JAX loops do."""

    def restore(self, state: TrainState, tag: str = "last",
                extra: Optional[dict] = None):
        """Load ``tag`` into ``state`` in place (and the best metric from
        its meta); returns ``state``. With ``extra`` (live tensors), also
        copies the saved extra tree into them and returns ``(state,
        extra)``, or ``(state, None)`` if the checkpoint has none."""
        sd = torch.load(self.directory / tag / STATE_FILE, map_location="cpu",
                        weights_only=True)
        state.load_state_dict(sd)
        meta_path = self.directory / f"{tag}_meta.json"
        if meta_path.exists():
            self.best = json.loads(meta_path.read_text()).get("best")
        if extra is None:
            return state
        if "extra" not in sd:
            return state, None
        _copy_tree(extra, sd["extra"], "extra")
        return state, extra

    def can_restore(self, tag: str = "last") -> bool:
        return (self.directory / tag / STATE_FILE).exists()

    # -- input-stream position (vit_tpu_torch/data/resume.py) --------------
    # A small JSON history keyed by optimizer step, written beside every
    # checkpoint, so --resume can fast-forward the input stream to the batch
    # after the one the restored step consumed. A history rather than one
    # entry, as in the JAX package, whose saves finish in the background.

    def save_data_state(self, step: int, data_state: Dict[str, Any], *,
                        keep: int = 8):
        if not _writer():
            return
        path = self.directory / "data_state.json"
        hist: Dict[str, Any] = {}
        if path.exists():
            try:
                hist = json.loads(path.read_text())
            except (json.JSONDecodeError, OSError):
                hist = {}
        hist[str(int(step))] = data_state
        for k in sorted(hist, key=int)[:-keep]:
            del hist[k]
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(hist))
        tmp.replace(path)

    def load_data_state(self, step: int) -> Optional[Dict[str, Any]]:
        """The entry for ``step``, or the newest entry at an earlier step,
        or None."""
        path = self.directory / "data_state.json"
        if not path.exists():
            return None
        try:
            hist = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            return None
        eligible = [int(k) for k in hist if int(k) <= int(step)]
        if not eligible:
            return None
        return hist[str(max(eligible))]


def _tag_path(directory: str, tag: Optional[str]) -> Path:
    d = Path(directory).absolute()
    if tag is None:
        tag = "best" if (d / "best" / STATE_FILE).exists() else "last"
    path = d / tag / STATE_FILE
    if not path.exists():
        raise FileNotFoundError(f"no '{tag}' checkpoint under {d}")
    return path


def load_params(directory: str, tag: Optional[str] = None, *,
                ema: bool = False) -> "dict[str, torch.Tensor]":
    """The parameters of a checkpoint, ``{name: tensor}`` on the host, with
    no state to load them into. ``tag=None`` prefers "best" over "last".
    ``ema=True`` returns the weight average instead, and raises on a
    checkpoint that holds none."""
    path = _tag_path(directory, tag)
    # mapped, so only the tensors returned are read (not the optimizer's)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if ema:
        if "ema_params" not in sd:
            raise ValueError(f"checkpoint {path.parent} holds no EMA average "
                             "(train with --ema_decay to write one)")
        return sd["ema_params"]
    return sd["params"]


def has_ema(directory: str, tag: str = "best") -> bool:
    """Whether a checkpoint was written by an ``--ema_decay`` run (its
    tensors are mapped, not read)."""
    sd = torch.load(_tag_path(directory, tag), map_location="cpu",
                    weights_only=True, mmap=True)
    return "ema_params" in sd
