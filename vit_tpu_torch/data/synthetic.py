"""Synthetic image and video batches (the port's own copies of
``vit_tpu/data/synthetic.py:14-84``, numpy only).

The same seed gives the same stream as the JAX package's loaders.
"""

from __future__ import annotations

import numpy as np

from vit_tpu_torch.data.shapes_demo import _draw_sample


class SyntheticImageLoader:
    """Yields (images NHWC float32, int32 labels) batches, deterministic per
    epoch. Each pass over the loader is the next epoch, drawn from
    ``default_rng((seed, epoch))``.

    ``mode="noise"``: i.i.d. standard-normal pixels, for throughput and
    classifier plumbing; a tokenizer cannot compress them, so its loss
    plateaus at the pixel variance. ``mode="shapes"``: random rectangles in
    [0, 1] (``data/shapes_demo.py``), where a tokenizer's reconstruction
    loss falls."""

    def __init__(self, image_size: int, batch_size: int, *,
                 num_classes: int = 1000, in_channels: int = 3,
                 steps_per_epoch: int = 50, seed: int = 0,
                 mode: str = "noise"):
        if mode not in ("noise", "shapes"):
            raise ValueError(f"unknown mode {mode!r}")
        self.image_size = image_size
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.steps_per_epoch = steps_per_epoch
        self.seed = seed
        self.mode = mode
        self._epoch = 0

    def __len__(self):
        return self.steps_per_epoch

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        if self.mode == "shapes":
            for _ in range(self.steps_per_epoch):
                images = np.stack([_draw_sample(rng, self.image_size)
                                   for _ in range(self.batch_size)])
                labels = rng.integers(0, self.num_classes, self.batch_size,
                                      dtype=np.int32)
                yield images.astype(np.float32), labels
            return
        for _ in range(self.steps_per_epoch):
            images = rng.standard_normal(
                (self.batch_size, self.image_size, self.image_size,
                 self.in_channels), dtype=np.float32)
            labels = rng.integers(0, self.num_classes, self.batch_size,
                                  dtype=np.int32)
            yield images, labels


class SyntheticVideoLoader:
    """Yields (videos (B, T, H, W, C) uint8, dummy actions (B, T) int32)
    batches, shaped like the DMLab video loader's (reference
    datasets.py:128-131)."""

    def __init__(self, batch_size: int, *, frames: int = 32,
                 image_size: int = 64, steps_per_epoch: int = 10,
                 seed: int = 0):
        self.batch_size = batch_size
        self.frames = frames
        self.image_size = image_size
        self.steps_per_epoch = steps_per_epoch
        self.seed = seed

    def __len__(self):
        return self.steps_per_epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.steps_per_epoch):
            videos = rng.integers(
                0, 256, (self.batch_size, self.frames, self.image_size,
                         self.image_size, 3), dtype=np.uint8)
            actions = np.zeros((self.batch_size, self.frames), np.int32)
            yield videos, actions
