"""Structured synthetic images: random coloured rectangles on gradient
backgrounds (the port's own copy of ``vit_tpu/data/shapes_demo.py:13-46``,
numpy only).

Unlike Gaussian noise, which no tokenizer can compress, these images have
structure a tokenizer learns, so a training run on them shows its
reconstruction loss falling. The same generator state draws the same images
as the JAX package's ``_draw_sample``.
"""

from __future__ import annotations

import numpy as np


def _draw_sample(rng: np.random.Generator, size: int) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    bg = np.stack([yy * rng.random(), xx * rng.random(),
                   (1 - yy) * rng.random()], axis=-1)
    img = bg.copy()
    for _ in range(rng.integers(1, 4)):
        h0, w0 = rng.integers(0, size // 2, 2)
        h1 = h0 + rng.integers(size // 8, size // 2)
        w1 = w0 + rng.integers(size // 8, size // 2)
        img[h0:h1, w0:w1] = rng.random(3)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


class ShapesImageLoader:
    """(B, S, S, 3) float32 images of random rectangles, no labels; each pass
    is the next epoch, drawn from ``default_rng((seed, epoch))``."""

    def __init__(self, image_size: int, batch_size: int, *,
                 steps_per_epoch: int = 100, seed: int = 0):
        self.image_size = image_size
        self.batch_size = batch_size
        self.steps_per_epoch = steps_per_epoch
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return self.steps_per_epoch

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        for _ in range(self.steps_per_epoch):
            batch = np.stack([_draw_sample(rng, self.image_size)
                              for _ in range(self.batch_size)])
            yield batch, None
