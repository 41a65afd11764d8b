"""Video datasets: DMLab (.npz), Minecraft (.mp4), UCF-101 (.avi), and the
frames-from-video sampler (the port's own copy of
``vit_tpu/data/video.py:22-185``).

DMLab clips are read by ``np.load`` and need no decoder. The Minecraft and
UCF-101 readers decode with OpenCV, imported inside ``_read_video_cv2``
only, so a machine without ``cv2`` imports this module and reads DMLab.

As in the JAX package, frames come out as float32 in [0, 1] from the image
loaders and as the clips' uint8 from the video loader. Each item of
``ImagesFromVideoDataset`` seeds its frame picks with ``(seed, idx)`` and a
draw from the global ``np.random`` (``vit_tpu/data/video.py:122``): under
several loader threads the draws' order, and so the frames, cannot be
reproduced from a seed, here as in JAX (ROADMAP Queue C, hazard 8). One
worker with ``np.random.seed`` set reproduces them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from vit_tpu_torch.data.loader import DataLoader


def _require_dir(path: Optional[str], what: str) -> Path:
    if path is None:
        raise ValueError(f"{what}: pass a dataset path (--data_dir), or use "
                         f"--dataset synthetic for a smoke run")
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"{what} directory not found: {p}")
    return p


def _read_video_cv2(path, max_frames: Optional[int] = None) -> np.ndarray:
    """Decode a video file to (T, H, W, 3) RGB uint8 (replaces
    torchvision.io.read_video, reference datasets.py:57,79)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])  # BGR → RGB
        if max_frames is not None and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


class DmlabDataset:
    """Per-video .npz with keys 'video' (T,H,W,C uint8) and 'actions'
    (reference datasets.py:31-46). Directory layout: <root>/<folder>/<video>.npz."""

    def __init__(self, dataset_path: str):
        root = _require_dir(dataset_path, "DMLab")
        self.video_paths = sorted(p for folder in sorted(root.iterdir())
                                  if folder.is_dir()
                                  for p in sorted(folder.iterdir()))

    def __len__(self):
        return len(self.video_paths)

    def __getitem__(self, idx: int):
        data = np.load(self.video_paths[idx])
        return data["video"], data["actions"]


class MinecraftDataset:
    """Per-video .mp4, first 300 frames, dummy actions (reference datasets.py:48-64)."""

    def __init__(self, dataset_path: str):
        root = _require_dir(dataset_path, "Minecraft")
        self.video_paths = sorted(p for folder in sorted(root.iterdir())
                                  if folder.is_dir()
                                  for p in sorted(folder.iterdir())
                                  if p.suffix == ".mp4")

    def __len__(self):
        return len(self.video_paths)

    def __getitem__(self, idx: int):
        video = _read_video_cv2(self.video_paths[idx], max_frames=300)
        return video, np.zeros((video.shape[0],), np.float32)


class UCF101Dataset:
    """.avi videos with class labels from folder names (reference datasets.py:66-86)."""

    def __init__(self, dataset_path: str):
        root = _require_dir(dataset_path, "UCF-101")
        self.classes = sorted(d.name for d in root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.video_paths = [
            {"video_path": p, "class": folder.name}
            for folder in sorted(root.iterdir()) if folder.is_dir()
            for p in sorted(folder.iterdir()) if p.suffix == ".avi"]

    def __len__(self):
        return len(self.video_paths)

    def __getitem__(self, idx: int):
        entry = self.video_paths[idx]
        video = _read_video_cv2(entry["video_path"])
        return video, self.class_to_idx[entry["class"]]


class ImagesFromVideoDataset:
    """Each item = ``frames_per_video`` random frames of one video; virtual length =
    1000 × videos (reference datasets.py:88-102)."""

    def __init__(self, video_dataset, frames_per_video: int = 8, seed: int = 0):
        self.video_dataset = video_dataset
        self.frames_per_video = frames_per_video
        self.seed = seed

    def __len__(self):
        return len(self.video_dataset) * 1000

    def __getitem__(self, idx: int):
        video, _ = self.video_dataset[idx % len(self.video_dataset)]
        rng = np.random.default_rng((self.seed, idx, np.random.randint(1 << 31)))
        picks = rng.integers(0, video.shape[0], self.frames_per_video)
        frames = np.asarray(video)[picks]
        return frames.astype(np.float32) / 255.0, None


def frames_collate(batch):
    """Flatten (b, f, h, w, c) → (b·f, h, w, c) (reference collate_fn,
    datasets.py:98-102)."""
    frames = np.stack([b[0] for b in batch])
    b, f = frames.shape[:2]
    return frames.reshape(b * f, *frames.shape[2:]), None


def video_batch_generator(dataset, batch_size: int, videos_per_batch: int = 4,
                          seed: int = 0):
    """Endless random-frame sampler (reference video_dataloader,
    datasets.py:105-113)."""
    rng = np.random.default_rng(seed)
    frames_per_video = batch_size // videos_per_batch
    while True:
        vids = [np.asarray(dataset[int(i)][0])
                for i in rng.choice(len(dataset), videos_per_batch)]
        frames = np.stack([v[rng.integers(0, v.shape[0], frames_per_video)]
                           for v in vids])
        yield (frames.reshape(-1, *frames.shape[2:]).astype(np.float32) / 255.0,
               None)


def get_dmlab_image_loaders(batch_size: int, dataset_path: Optional[str] = None,
                            *, shard_id: int = 0, num_shards: int = 1
                            ) -> Tuple[DataLoader, None]:
    """batch_size//8 videos × 8 frames per batch (reference datasets.py:115-120).

    (shard_id, num_shards): this process's slice of the shuffled index
    permutation; the entries pass 0 and 1 (one GPU)."""
    dataset = ImagesFromVideoDataset(DmlabDataset(dataset_path))
    loader = DataLoader(dataset, batch_size // 8, shuffle=True, drop_last=True,
                        num_workers=8, prefetch=2, collate_fn=frames_collate,
                        shard_id=shard_id, num_shards=num_shards)
    return loader, None


def get_minecraft_image_loaders(batch_size: int, dataset_path: Optional[str] = None,
                                *, shard_id: int = 0, num_shards: int = 1
                                ) -> Tuple[DataLoader, None]:
    dataset = ImagesFromVideoDataset(
        MinecraftDataset(dataset_path))
    loader = DataLoader(dataset, batch_size // 8, shuffle=True, drop_last=True,
                        num_workers=8, prefetch=2, collate_fn=frames_collate,
                        shard_id=shard_id, num_shards=num_shards)
    return loader, None


def get_dmlab_video_loaders(batch_size: int, dataset_path: Optional[str] = None,
                            *, shard_id: int = 0, num_shards: int = 1
                            ) -> Tuple[DataLoader, None]:
    """Whole-video batches (reference datasets.py:128-131)."""
    dataset = DmlabDataset(dataset_path)
    loader = DataLoader(dataset, batch_size, shuffle=True, drop_last=True,
                        num_workers=8, prefetch=2,
                        shard_id=shard_id, num_shards=num_shards)
    return loader, None
