"""Image transforms with the reference's torchvision semantics (the port's
own copy of ``vit_tpu/data/transforms.py:16-65``): Resize(shorter side,
bilinear antialias) → RandomCrop / CenterCrop → RandomHorizontalFlip →
scale to [0, 1] → Normalize(ImageNet mean/std), as NHWC float32.

The images are Pillow images; Pillow is imported where a function resizes,
so this module imports on a machine without it.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def resize_shorter(img: "Image.Image", size: int) -> "Image.Image":
    """torchvision Resize(int): shorter side → size, aspect preserved, bilinear."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        new = (size, max(1, round(h * size / w)))
    else:
        new = (max(1, round(w * size / h)), size)
    return img.resize(new, Image.BILINEAR)


def random_crop(arr: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    h, w = arr.shape[:2]
    top = 0 if h == size else int(rng.integers(0, h - size + 1))
    left = 0 if w == size else int(rng.integers(0, w - size + 1))
    return arr[top:top + size, left:left + size]


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return arr[top:top + size, left:left + size]


def normalize(arr01: np.ndarray) -> np.ndarray:
    return (arr01 - IMAGENET_MEAN) / IMAGENET_STD


def train_transform(img: "Image.Image", image_size: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Resize → RandomCrop → RandomHorizontalFlip → [0,1] → Normalize. NHWC fp32."""
    img = resize_shorter(img.convert("RGB"), image_size)
    arr = np.asarray(img, np.uint8)
    arr = random_crop(arr, image_size, rng)
    if rng.random() < 0.5:
        arr = arr[:, ::-1]
    return normalize(arr.astype(np.float32) / 255.0)


def eval_transform(img: "Image.Image", image_size: int) -> np.ndarray:
    """Resize → CenterCrop → [0,1] → Normalize. NHWC fp32."""
    img = resize_shorter(img.convert("RGB"), image_size)
    arr = np.asarray(img, np.uint8)
    arr = center_crop(arr, image_size)
    return normalize(arr.astype(np.float32) / 255.0)
