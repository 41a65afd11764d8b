"""ImageNet-style folder loaders (the port's own copy of
``vit_tpu/data/imagenet.py:22-136``, reference datasets.py:7-28).

Layout: ``<data_dir>/train/<class>/<img>.JPEG`` and ``<data_dir>/val/...``.
Same loader shape as the reference: a shuffled drop_last train loader with
8 workers and prefetch 2, and a sequential val loader at twice the batch.
``use_native="auto"`` decodes whole batches in the native pipeline
(``data/native.py``) when its library builds, else each image through
Pillow (imported where an image is opened).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from vit_tpu_torch.data.loader import DataLoader
from vit_tpu_torch.data.transforms import eval_transform, train_transform
from vit_tpu_torch.data.video import _require_dir

_IMG_EXTS = {".jpeg", ".jpg", ".png", ".bmp", ".webp"}


class ImageFolderDataset:
    """<root>/<class>/<image> with labels from sorted class-dir names."""

    def __init__(self, root: str, image_size: int, *, train: bool, seed: int = 0):
        self.root = Path(root)
        if not self.root.is_dir():
            raise FileNotFoundError(
                f"ImageNet directory not found: {self.root}. Pass --data_dir (or use "
                f"--dataset synthetic for a smoke run).")
        self.image_size = image_size
        self.train = train
        self.seed = seed
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            for f in sorted((self.root / c).iterdir()):
                if f.suffix.lower() in _IMG_EXTS:
                    self.samples.append((f, self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        from PIL import Image

        path, label = self.samples[idx]
        img = Image.open(path)
        if self.train:
            rng = np.random.default_rng((self.seed, idx, np.random.randint(1 << 31)))
            arr = train_transform(img, self.image_size, rng)
        else:
            arr = eval_transform(img, self.image_size)
        return arr.astype(np.float32), np.int32(label)


class RawJpegDataset:
    """(jpeg bytes, label) view for the native C++ batch decoder."""

    def __init__(self, folder: ImageFolderDataset):
        self.folder = folder

    def __len__(self):
        return len(self.folder)

    def __getitem__(self, idx: int):
        path, label = self.folder.samples[idx]
        return path.read_bytes(), np.int32(label)


def _native_collate(image_size: int, train: bool, num_threads: int):
    from vit_tpu_torch.data import native

    def collate(samples):
        jpegs = [s[0] for s in samples]
        labels = np.asarray([s[1] for s in samples], np.int32)
        seed = int(np.random.randint(1 << 31)) if train else 0
        images = native.decode_batch(jpegs, image_size, train=train, seed=seed,
                                     num_threads=num_threads)
        return images, labels

    return collate


def get_imagenet_loaders(image_size: int, bs: int,
                         data_dir: Optional[str] = None,
                         num_workers: int = 8,
                         shard_id: int = 0, num_shards: int = 1,
                         use_native: str = "auto",
                         backend: str = "threads",
                         processes: int = 0
                         ) -> Tuple[DataLoader, DataLoader]:
    """Loader parity with reference datasets.py:7-28.

    use_native: "auto" uses the C++ batch decoder (native/image_pipeline.cc) when the
    library builds; "never" forces the PIL path; "always" errors if unavailable.
    backend: "threads" (loader.DataLoader) or "grain" (grain_loader.GrainDataLoader);
    both compose with the native collate.
    processes: grain multiprocess worker count (0 = in-process reader threads);
    collation stays in the parent, so only the picklable dataset ships to workers.
    """
    from vit_tpu_torch.data.grain_loader import make_loader
    root = _require_dir(data_dir, "ImageNet")
    train_set = ImageFolderDataset(root / "train", image_size, train=True)
    valid_set = ImageFolderDataset(root / "val", image_size, train=False)

    native_on = False
    if use_native != "never":
        from vit_tpu_torch.data import native

        native_on = native.is_available()
        if use_native == "always" and not native_on:
            raise RuntimeError("native image pipeline unavailable")

    if native_on:
        train_loader = make_loader(
            RawJpegDataset(train_set), bs, backend=backend, shuffle=True,
            drop_last=True, num_workers=num_workers, prefetch=2,
            collate_fn=_native_collate(image_size, True, num_workers),
            shard_id=shard_id, num_shards=num_shards, processes=processes)
        valid_loader = make_loader(
            RawJpegDataset(valid_set), 2 * bs, backend=backend, shuffle=False,
            drop_last=False, num_workers=max(1, num_workers // 2),
            collate_fn=_native_collate(image_size, False, num_workers),
            shard_id=shard_id, num_shards=num_shards, processes=processes)
        return train_loader, valid_loader

    train_loader = make_loader(train_set, bs, backend=backend, shuffle=True,
                               drop_last=True, num_workers=num_workers,
                               prefetch=2, shard_id=shard_id,
                               num_shards=num_shards, processes=processes)
    valid_loader = make_loader(valid_set, 2 * bs, backend=backend,
                               shuffle=False, drop_last=False,
                               num_workers=max(1, num_workers // 2),
                               shard_id=shard_id, num_shards=num_shards, processes=processes)
    return train_loader, valid_loader
