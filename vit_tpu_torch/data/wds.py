"""WebDataset-format tar shard IO (the port's own copy of
``vit_tpu/data/wds.py:23-393``; no ``webdataset`` package: ``tarfile``).

A shard is a tar archive whose member names are "<key>.<ext>"; consecutive
members with the same key form one sample, as the webdataset library writes
them. Payloads by extension: ``npy`` (arrays), ``cls`` (int), ``json``,
``pth`` (torch tensors), ``jpg``/``jpeg``/``png`` (images through Pillow,
imported when such a payload is met, so a machine without Pillow reads and
writes the others), raw bytes otherwise.
"""

from __future__ import annotations

import io
import json
import tarfile
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np


def _encode(ext: str, value) -> bytes:
    ext = ext.split(".")[-1]    # multi-part extensions like "sequence.npy"
    if ext in ("jpg", "jpeg", "png"):
        from PIL import Image

        if isinstance(value, Image.Image):
            img = value
        else:
            img = Image.fromarray(np.asarray(value))
        buf = io.BytesIO()
        img.save(buf, format="JPEG" if ext in ("jpg", "jpeg") else "PNG")
        return buf.getvalue()
    if ext == "cls":
        return str(int(value)).encode()
    if ext == "npy":
        buf = io.BytesIO()
        np.save(buf, np.asarray(value))
        return buf.getvalue()
    if ext == "pth":
        import torch

        buf = io.BytesIO()
        torch.save(value if isinstance(value, torch.Tensor)
                   else torch.from_numpy(np.asarray(value)), buf)
        return buf.getvalue()
    if ext == "json":
        return json.dumps(value).encode()
    if isinstance(value, bytes):
        return value
    raise ValueError(f"cannot encode extension {ext!r}")


def _decode(ext: str, data: bytes):
    ext = ext.split(".")[-1]    # multi-part extensions like "sequence.npy"
    if ext in ("jpg", "jpeg", "png"):
        from PIL import Image

        return Image.open(io.BytesIO(data)).convert("RGB")
    if ext == "cls":
        return int(data.decode())
    if ext == "npy":
        return np.load(io.BytesIO(data))
    if ext == "pth":
        import torch

        return torch.load(io.BytesIO(data), map_location="cpu",
                          weights_only=False).numpy()
    if ext == "json":
        return json.loads(data.decode())
    return data


class ShardWriter:
    """wds.ShardWriter equivalent: write({'__key__': k, 'jpg': img, 'cls': 3})."""

    def __init__(self, pattern: str, maxcount: int = 10000):
        self.pattern = pattern
        self.maxcount = maxcount
        self.shard_idx = 0
        self.count = 0
        self.total = 0
        self._tar: Optional[tarfile.TarFile] = None
        self.paths: List[str] = []

    def _open_next(self):
        self._close_current()
        path = self.pattern % self.shard_idx
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._tar = tarfile.open(path, "w")
        self.paths.append(path)
        self.shard_idx += 1
        self.count = 0

    def _close_current(self):
        if self._tar is not None:
            self._tar.close()
            self._tar = None

    def write(self, sample: Dict):
        if self._tar is None or self.count >= self.maxcount:
            self._open_next()
        key = sample["__key__"]
        for ext, value in sample.items():
            if ext == "__key__":
                continue
            data = _encode(ext, value)
            info = tarfile.TarInfo(f"{key}.{ext}")
            info.size = len(data)
            self._tar.addfile(info, io.BytesIO(data))
        self.count += 1
        self.total += 1

    def close(self):
        self._close_current()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iterate_shard(path, decode: bool = True) -> Iterator[Dict]:
    """Yield samples from one tar shard (decode=False keeps raw bytes — the
    native C++ batch decoder consumes those directly)."""
    with tarfile.open(path, "r") as tar:
        current_key = None
        sample: Dict = {}
        for member in tar:
            if not member.isfile():
                continue
            # WebDataset convention: key = up to the FIRST dot of the basename,
            # extension = the (possibly multi-part) rest
            base = member.name
            key, ext = base.split(".", 1)
            if key != current_key:
                if sample:
                    yield sample
                current_key, sample = key, {"__key__": key}
            raw = tar.extractfile(member).read()
            sample[ext] = _decode(ext, raw) if decode else raw
        if sample:
            yield sample


class StreamingWebDataset:
    """Iterable WebDataset: sequential tar streaming with a bounded shuffle buffer.

    The map-style ``WebDataset`` below holds every sample in memory — fine
    for smoke-scale shards, wrong for ImageNet-scale shards (the reference
    streams via the webdataset library, convert2webdaset.py:38). This
    reader:
      - streams tar members sequentially, never holding more than the shuffle
        buffer in memory;
      - shuffles shard ORDER per epoch (seed+epoch) and samples through a bounded
        buffer (webdataset ``.shuffle(n)`` semantics);
      - slices the SHARD LIST by shard_id/num_shards for data parallelism;
      - overlaps decode with consumption: ``workers`` threads each stream their
        own shards (PIL/zlib decode releases the GIL) into a bounded queue.

    ``transform(sample) -> item`` runs on the worker threads.
    """

    def __init__(self, shard_paths, *, shuffle_buffer: int = 1000, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1, workers: int = 4,
                 transform=None, queue_size: int = 256, decode: bool = True):
        all_shards = sorted(str(s) for s in shard_paths)
        if num_shards > 1:
            # equal work a shard: an uneven split would give the shards'
            # processes different batch counts (the map-style DataLoader
            # cuts its indices the same way, data/loader.py:_indices).
            # ShardWriter's shards hold maxcount samples EXCEPT the final
            # one (total % maxcount, usually partial), so the sorted-last
            # shard is dropped before the split: every selected shard is
            # then full-size and equal shard COUNTS give equal batch counts.
            # For foreign shards of uneven sizes this is best-effort.
            usable = all_shards[:-1] if len(all_shards) > 1 else all_shards
            per = len(usable) // num_shards
            if per == 0:
                raise ValueError(
                    f"{len(all_shards)} shard(s) < {num_shards} hosts (after "
                    f"dropping the possibly-partial final shard) — each host "
                    f"needs >= 1 full shard for a collective-safe epoch "
                    f"split; re-shard with a smaller maxcount")
            self.shard_paths = usable[shard_id::num_shards][:per]
            # the equalized split shrinks the epoch: the final shard plus up
            # to num_shards-1 remainder shards are read by no shard, so say
            # so in the run's log
            dropped = len(all_shards) - per * num_shards
            if dropped and shard_id == 0:
                print(f"[wds] equalized {num_shards}-host split reads "
                      f"{per * num_shards} of {len(all_shards)} shards "
                      f"({dropped} dropped: the possibly-partial final shard "
                      f"+ {max(0, dropped - 1)} remainder shard(s))")
        else:
            self.shard_paths = all_shards
        if not self.shard_paths:
            raise ValueError("no shards for this shard_id/num_shards slice")
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.workers = max(1, min(workers, len(self.shard_paths)))
        self.transform = transform
        self.queue_size = queue_size
        self.decode = decode
        self._epoch = 0

    def __iter__(self):
        import queue
        import threading

        epoch = self._epoch
        self._epoch += 1
        rng = np.random.default_rng((self.seed, epoch))
        shards = list(self.shard_paths)
        if self.shuffle_buffer:
            rng.shuffle(shards)

        out_q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        lock = threading.Lock()
        cursor = [0]
        sentinel = object()

        def worker():
            while True:
                with lock:
                    i = cursor[0]
                    cursor[0] += 1
                if i >= len(shards):
                    out_q.put(sentinel)
                    return
                for sample in iterate_shard(shards[i], decode=self.decode):
                    item = self.transform(sample) if self.transform else sample
                    out_q.put(item)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.workers)]
        for t in threads:
            t.start()

        buf: List = []
        done = 0
        while done < len(threads):
            item = out_q.get()
            if item is sentinel:
                done += 1
                continue
            if not self.shuffle_buffer:
                yield item
                continue
            if len(buf) < self.shuffle_buffer:
                buf.append(item)
            else:
                j = int(rng.integers(len(buf)))
                buf[j], item = item, buf[j]
                yield item
        if buf:
            rng.shuffle(buf)
            yield from buf
        for t in threads:
            t.join()


class StreamingBatcher:
    """Batch an iterable dataset; re-iterating starts the next epoch."""

    def __init__(self, dataset, batch_size: int, *, drop_last: bool = True,
                 collate_fn=None):
        from vit_tpu_torch.data.loader import default_collate

        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate

    def __iter__(self):
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)


def streaming_image_loader(shard_paths, image_size: int, batch_size: int, *,
                           train: bool = True, seed: int = 0,
                           shuffle_buffer: int = 1000, workers: int = 4,
                           shard_id: int = 0, num_shards: int = 1,
                           native: "bool | None" = None):
    """Streaming jpg+cls shards → (images NHWC fp32, labels) batches — the
    ImageNet-scale replacement for WdsImageClassification + map DataLoader.

    native=True (or None with the C++ library available) streams RAW jpeg bytes
    through the shuffle buffer and decodes whole batches in the native threaded
    pipeline (native/image_pipeline.cc: libjpeg decode + resize/crop/flip +
    normalize) — the per-sample PIL path is the fallback."""
    import zlib

    from vit_tpu_torch.data import native as native_mod

    use_native = native_mod.is_available() if native is None else native
    if use_native:
        def transform(sample):
            return (sample["jpg"],
                    np.int32(int(sample.get("cls", b"0").decode())))

        batch_counter = [seed]

        def collate(samples):
            jpegs = [s[0] for s in samples]
            labels = np.asarray([s[1] for s in samples], np.int32)
            batch_counter[0] += 1
            images = native_mod.decode_batch(jpegs, image_size, train=train,
                                             seed=batch_counter[0])
            return images, labels

        ds = StreamingWebDataset(
            shard_paths, shuffle_buffer=shuffle_buffer if train else 0,
            seed=seed, shard_id=shard_id, num_shards=num_shards,
            workers=workers, transform=transform, decode=False)
        return StreamingBatcher(ds, batch_size, drop_last=train,
                                collate_fn=collate)

    from vit_tpu_torch.data.transforms import eval_transform, train_transform

    def transform(sample):
        img = sample["jpg"]
        if train:
            # per-sample deterministic stream — safe across worker threads
            rng = np.random.default_rng(
                (seed, zlib.crc32(sample["__key__"].encode())))
            arr = train_transform(img, image_size, rng)
        else:
            arr = eval_transform(img, image_size)
        return arr.astype(np.float32), np.int32(sample.get("cls", 0))

    ds = StreamingWebDataset(shard_paths, shuffle_buffer=shuffle_buffer if train
                             else 0, seed=seed, shard_id=shard_id,
                             num_shards=num_shards, workers=workers,
                             transform=transform)
    return StreamingBatcher(ds, batch_size, drop_last=train)


class WebDataset:
    """Map-style dataset over a list of shards (indexes built lazily in memory)."""

    def __init__(self, shard_paths):
        self.samples: List = []
        for p in sorted(str(s) for s in shard_paths):
            for sample in iterate_shard(p):
                self.samples.append(sample)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict:
        return self.samples[idx]


class WdsImageClassification:
    """(image NHWC fp32 normalized, label) view over jpg+cls shards — the
    BASELINE.json configs[0] 'tiny webdataset shard' train_vit path."""

    def __init__(self, shard_paths, image_size: int, *, train: bool = True,
                 seed: int = 0):
        from vit_tpu_torch.data.transforms import eval_transform, train_transform

        self._train_transform = train_transform
        self._eval_transform = eval_transform
        self.inner = WebDataset(shard_paths)
        self.image_size = image_size
        self.train = train
        self.seed = seed

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, idx: int):
        sample = self.inner[idx]
        img = sample["jpg"]
        if self.train:
            rng = np.random.default_rng((self.seed, idx))
            arr = self._train_transform(img, self.image_size, rng)
        else:
            arr = self._eval_transform(img, self.image_size)
        return arr.astype(np.float32), np.int32(sample.get("cls", 0))
