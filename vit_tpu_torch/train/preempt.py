"""Save on SIGTERM for preemptible hosts (counterpart of
``vit_tpu/train/preempt.py:24``).

Schedulers send SIGTERM a short grace window before they kill a job. The
train loops poll ``requested`` once a step and, when it is set, write a
"last" checkpoint with the stream position and return, so ``--resume``
continues from the interrupted step rather than from the last interval save.

One process only: in a ``torch.distributed`` job of more than one process a
save on one rank alone would leave the others waiting, so there the handler
is not installed and the interval saves (``--ckpt_every``) with
``--resume`` are the recovery.
"""

from __future__ import annotations

import signal
import threading

import torch.distributed as dist


class GracefulShutdown:
    """Installs SIGTERM handlers (chained to the previous ones) that set
    ``requested``."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    @classmethod
    def install(cls, signals=(signal.SIGTERM,)):
        self = cls()
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            return self  # one rank's save would stall the others
        if threading.current_thread() is not threading.main_thread():
            return self  # signal.signal is main-thread-only
        for sig in signals:
            def handler(signum, frame, self=self):
                self.requested = True
                prev = self._prev.get(signum)
                if callable(prev):
                    prev(signum, frame)

            self._prev[sig] = signal.signal(sig, handler)
        return self

    def uninstall(self) -> None:
        """Put the previous handlers back (a loop run inside a longer
        process leaves SIGTERM as it found it)."""
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
