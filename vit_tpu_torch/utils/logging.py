"""Metrics logging: an append-only JSONL file, TensorBoard when
``tensorboardX`` is importable, and PNG image grids (counterpart of
``vit_tpu/utils/logging.py:45-193``).

The files are the JAX package's: ``<out_dir>/<project>/<name>.jsonl``, with
``out_dir`` from the argument (``--run_dir``), else ``$VIT_TPU_RUN_DIR``,
else ``runs``. The first line holds the run's ``_config`` (its scalar
entries), ``_platform`` and ``_ts``; every other line a record with
``_step`` and ``_ts``. ``_platform`` is ``"cuda"`` with the card's name in
``_device``, or ``"cpu"``. Images go to ``<name>_images/<key>_<step>_<j>.png``,
written with ``zlib`` and ``struct`` from the standard library. ``--watch``
histograms go to the TensorBoard sink only, as raw histograms. The JAX
logger's wandb sink is not ported: ``--no_wandb`` or not, the port logs to
these files.

Values are read on the host only when ``log`` is called: the train loops
fetch a log step's metrics in one copy and pass host numbers.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def _to_python(v):
    if hasattr(v, "item"):
        return v.item()
    return v


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray) -> None:
    """An (H, W, 3) image in [0, 1] as an 8-bit RGB PNG."""
    img8 = np.clip(np.asarray(img, np.float32) * 255.0, 0, 255).astype(
        np.uint8)
    h, w = img8.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img8.reshape(h, w * 3)], axis=1)  # filter 0 a row
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b""))


def _platform(device) -> dict:
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        return {"_platform": "cuda",
                "_device": torch.cuda.get_device_name(device)}
    return {"_platform": "cpu"}


class MetricsLogger:
    def __init__(self, project: str, name: str,
                 config: Optional[Dict[str, Any]] = None,
                 out_dir: Optional[str] = None, tb: bool = True,
                 device=None):
        if out_dir is None:
            out_dir = os.environ.get("VIT_TPU_RUN_DIR") or "runs"
        self.project = project
        self.name = name
        self._tb = None
        # in a torch.distributed job only rank 0 writes: the logged values
        # are the same on every rank
        self._active = not (dist.is_available() and dist.is_initialized()
                            and dist.get_rank() != 0)
        if not self._active:
            return
        self.path = Path(out_dir) / project / f"{name}.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("a")
        scalars = {k: _to_python(v) for k, v in (config or {}).items()
                   if isinstance(v, (int, float, str, bool, type(None)))}
        if tb:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(
                    logdir=str(self.path.parent / f"{name}_tb"),
                    flush_secs=30)
                if config is not None:
                    self._tb.add_text("config", "```\n" + "\n".join(
                        f"{k}: {v}" for k, v in sorted(scalars.items()))
                        + "\n```", 0)
        if config is not None:
            self._fh.write(json.dumps({"_config": scalars, **_platform(device),
                                       "_ts": time.time()}) + "\n")
            self._fh.flush()

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        if not self._active:
            return
        payload = {k: _to_python(v) for k, v in metrics.items()}
        if step is not None:
            payload["_step"] = int(step)
        payload["_ts"] = time.time()
        if self._tb is not None:
            for k, v in payload.items():
                if not k.startswith("_") and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, global_step=step)
        self._fh.write(json.dumps(payload) + "\n")
        self._fh.flush()

    def log_histograms(self, hists: Dict[str, Any],
                       step: Optional[int] = None):
        """``{key: (counts, edges)}`` host arrays (``utils/metrics.py:
        tree_histograms``, fetched) → TensorBoard raw histograms; nothing
        without a TensorBoard sink, as the JAX logger without wandb."""
        if not self._active or self._tb is None:
            return
        for k, (counts, edges) in hists.items():
            counts = np.asarray(counts, np.float64)
            edges = np.asarray(edges, np.float64)
            mids = (edges[:-1] + edges[1:]) / 2.0
            self._tb.add_histogram_raw(
                k, min=float(edges[0]), max=float(edges[-1]),
                num=int(counts.sum()), sum=float((mids * counts).sum()),
                sum_squares=float((mids ** 2 * counts).sum()),
                bucket_limits=edges[1:].tolist(),
                bucket_counts=counts.tolist(), global_step=step)

    def log_images(self, images: Dict[str, Any], step: Optional[int] = None):
        """``{key: (N, H, W, 3) array in [0, 1]}`` → one PNG per image under
        ``<name>_images/`` (and TensorBoard image grids)."""
        if not self._active:
            return
        if self._tb is not None:
            for key, batch in images.items():
                arr = np.clip(np.asarray(batch, dtype=np.float32), 0.0, 1.0)
                self._tb.add_images(key, arr, global_step=step,
                                    dataformats="NHWC")
        img_dir = self.path.parent / f"{self.name}_images"
        img_dir.mkdir(parents=True, exist_ok=True)
        for key, batch in images.items():
            for j, img in enumerate(np.asarray(batch)):
                write_png(img_dir / f"{key}_{step if step is not None else 0}"
                                    f"_{j}.png", img)

    def close(self):
        if not self._active:
            return
        if self._tb is not None:
            self._tb.close()
        self._fh.close()
