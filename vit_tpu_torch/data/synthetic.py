"""Synthetic video batches (the port's own copy of
``vit_tpu/data/synthetic.py:61-84``, numpy only).

The same seed gives the same stream as the JAX package's loader.
"""

from __future__ import annotations

import numpy as np


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
