"""Threaded prefetching data loader (the port's own copy of
``vit_tpu/data/loader.py:23-113``).

A thread pool runs the dataset's ``__getitem__`` (decode work in PIL, cv2,
zlib and libjpeg releases the GIL) and a bounded queue keeps ``prefetch``
batches ahead of the consumer. Each ``__iter__`` is the next epoch: the
shuffle is ``default_rng(seed + epoch)``'s permutation, then this shard's
stride ``shard_id::num_shards`` (cut to an equal length on every shard).
``_epoch`` and ``_skip_next`` are the hooks ``data/resume.py`` sets to
resume a stream mid-epoch; a skip slices the epoch's permutation, so the
skipped samples are never read.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np


def default_collate(samples: Sequence):
    """Stack tuple-of-arrays samples into batch arrays."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate([s[i] for s in samples])
                     for i in range(len(first)))
    if first is None:
        return None
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Map-style dataset → shuffled, batched, prefetched iterator.

    dataset: object with __len__ and __getitem__(int).
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 prefetch: int = 2, collate_fn: Optional[Callable] = None,
                 seed: int = 0, shard_id: int = 0, num_shards: int = 1):
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
        self._epoch = 0
        # one-shot batch skip applied by the next __iter__ (data-pipeline
        # resume, data/resume.py): slices the epoch's index
        # permutation so skipped samples are never decoded
        self._skip_next = 0

    def _indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        idx = idx[self.shard_id::self.num_shards]
        if self.num_shards > 1:
            # equal length on every shard: an uneven tail would give the
            # shards' processes different batch counts
            idx = idx[:n // self.num_shards]
        nb = len(idx) // self.batch_size
        if not self.drop_last and len(idx) % self.batch_size:
            nb += 1
        return idx, nb

    def __len__(self):
        _, nb = self._indices()
        return nb

    def __iter__(self):
        idx, nb = self._indices()
        self._epoch += 1
        skip, self._skip_next = self._skip_next, 0
        if skip:
            idx = idx[skip * self.batch_size:]
            nb = max(0, nb - skip)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = []
                for b in range(nb):
                    batch_idx = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    futures.append([pool.submit(self.dataset.__getitem__, int(i))
                                    for i in batch_idx])
                    # keep at most `prefetch+1` batches of futures outstanding
                    while len(futures) > self.prefetch + 1:
                        done = futures.pop(0)
                        out_q.put(self.collate_fn([f.result() for f in done]))
                for done in futures:
                    out_q.put(self.collate_fn([f.result() for f in done]))
            out_q.put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        while True:
            item = out_q.get()
            if item is sentinel:
                break
            yield item
        thread.join()
