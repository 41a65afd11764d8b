"""Resume the input stream, not just the weights (the port's own copy of
``vit_tpu/data/resume.py:37-76``).

Every loader of the port keys its draws off ``(seed, epoch)`` and holds the
epoch in an ``_epoch`` attribute that each ``__iter__`` increments. A stream
position is therefore ``{"epoch": E, "next_batch": B}``: set the epoch
counter back to E and skip the first B batches of that epoch. The train
loops write that dict beside every checkpoint
(``train/checkpoint.py:Checkpointer.save_data_state``) and call the two
helpers below on ``--resume``. For the synthetic loaders the skip is exact:
the skipped batches cost host draws only.
"""

from __future__ import annotations

from typing import Iterator

_SENTINEL = object()


def set_stream_epoch(loader, epoch: int) -> bool:
    """Set every ``_epoch`` along ``loader`` and its ``.dataset`` chain to
    ``epoch``; returns whether any was set."""
    seen = set()
    obj = loader
    found = False
    while obj is not None and id(obj) not in seen:
        seen.add(id(obj))
        if hasattr(obj, "_epoch"):
            obj._epoch = int(epoch)
            found = True
        obj = getattr(obj, "dataset", None)
    return found


def resume_stream(loader, skip: int) -> Iterator:
    """One epoch of ``loader`` without its first ``skip`` batches.

    A loader with a ``_skip_next`` attribute skips natively; any other is
    consumed and the skipped batches dropped. ``skip`` at or past the end of
    the epoch yields nothing, so the caller's epoch loop moves on to the
    next epoch (a checkpoint written at an epoch boundary)."""
    if skip <= 0:
        return iter(loader)
    if hasattr(loader, "_skip_next"):
        loader._skip_next = int(skip)
        return iter(loader)

    def gen():
        it = iter(loader)
        for _ in range(skip):
            if next(it, _SENTINEL) is _SENTINEL:
                return
        yield from it

    return gen()
