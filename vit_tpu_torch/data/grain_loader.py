"""Grain-backed data loader (the port's own copy of
``vit_tpu/data/grain_loader.py:27-157``), a drop-in alternative to
``data/loader.py:DataLoader``.

``GrainDataLoader`` wraps ``grain.python.DataLoader`` behind the threaded
loader's interface, so every ``get_*_loaders`` function can switch backends
with ``backend="grain"``: each epoch an ``IndexSampler`` seeded with
``seed + epoch``, reads on ``num_workers`` threads in-process
(``processes=0``) or in ``processes`` worker processes, batches collated
here by the caller's ``collate_fn``. Grain is imported when a loader
iterates, so this module imports without it. Shard assignment differs from
the threaded loader on purpose: see ``_SourceAdapter``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from vit_tpu_torch.data.loader import default_collate


def grain_available() -> bool:
    try:
        import grain.python  # noqa: F401
        return True
    except Exception:  # pragma: no cover - environment-dependent
        return False


class GrainDataLoader:
    """Map-style dataset -> shuffled, batched, prefetched iterator via Grain.

    Constructor surface matches loader.DataLoader. Each ``__iter__`` builds a
    fresh single-epoch ``IndexSampler`` seeded with ``seed + epoch`` so epochs
    reshuffle deterministically (mirroring the threaded loader's
    ``np.random.default_rng(seed + epoch)`` discipline).

    worker_count=0 runs reads in-process on ``num_workers`` reader threads
    (ReadOptions.num_threads) — right for GIL-releasing decoders and avoids
    multiprocess spawn in tests; pass ``processes > 0`` for true multiprocess
    workers on GIL-bound datasets.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 prefetch: int = 2, collate_fn: Optional[Callable] = None,
                 seed: int = 0, shard_id: int = 0, num_shards: int = 1,
                 processes: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.collate_fn = collate_fn or default_collate
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.processes = processes
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        nb = n // self.batch_size
        if not self.drop_last and n % self.batch_size:
            nb += 1
        return nb

    def __iter__(self):
        import grain.python as gp

        epoch_seed = self.seed + self._epoch
        self._epoch += 1
        sampler = gp.IndexSampler(
            num_records=len(self.dataset),
            # drop_remainder=False: keep every record (unequal shards by ≤1),
            # matching the threaded loader's strided partition — batch-level
            # drop_last is handled in the batching loop below.
            shard_options=gp.ShardOptions(shard_index=self.shard_id,
                                          shard_count=self.num_shards,
                                          drop_remainder=False),
            shuffle=self.shuffle,
            num_epochs=1,
            seed=epoch_seed,
        )
        loader = gp.DataLoader(
            data_source=_SourceAdapter(self.dataset, self.seed
                                       if self.shuffle else None),
            sampler=sampler,
            operations=[],
            worker_count=self.processes,
            read_options=gp.ReadOptions(num_threads=self.num_workers,
                                        prefetch_buffer_size=max(
                                            self.prefetch * self.batch_size, 1)),
        )
        # Batch on our side with the caller's collate_fn: grain's Batch operation
        # tree-stacks, but several datasets return tuples with None members
        # (video datasets' dummy actions) that default_collate understands.
        buf = []
        for record in loader:
            buf.append(record)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)


class _SourceAdapter:
    """Adapt a map-style dataset to grain's RandomAccessDataSource protocol.

    ``perm_seed`` applies a FIXED seed-derived global permutation under grain's
    record keys. Grain's IndexSampler shards CONTIGUOUSLY before shuffling, so
    without this each host would own a fixed contiguous dataset interval —
    class-skewed for class-sorted layouts like ImageFolderDataset. With the
    permutation, shards are random (epoch-independent) subsets; within-shard
    order still reshuffles per epoch via the sampler seed. Remaining divergence
    from the threaded loader (which re-partitions globally every epoch): shard
    MEMBERSHIP is fixed across epochs — the standard fixed-shard-assignment
    discipline of production input pipelines."""

    def __init__(self, dataset, perm_seed=None):
        self._dataset = dataset
        self._perm = (np.random.default_rng(perm_seed).permutation(len(dataset))
                      if perm_seed is not None else None)

    def __len__(self) -> int:
        return len(self._dataset)

    def __getitem__(self, record_key) -> object:
        idx = int(record_key)
        if self._perm is not None:
            idx = int(self._perm[idx])
        return self._dataset[idx]

    def __repr__(self) -> str:  # pragma: no cover
        return f"_SourceAdapter({self._dataset!r})"


def make_loader(dataset, batch_size: int, *, backend: str = "threads", **kw):
    """Loader factory: backend="threads" (loader.DataLoader) or "grain"."""
    if backend == "grain":
        if not grain_available():
            raise RuntimeError("backend='grain' requested but grain is not "
                               "installed; use backend='threads'")
        return GrainDataLoader(dataset, batch_size, **kw)
    if backend != "threads":
        raise ValueError(f"unknown loader backend {backend!r}")
    from vit_tpu_torch.data.loader import DataLoader
    kw.pop("processes", None)
    return DataLoader(dataset, batch_size, **kw)
