"""Named wall-clock sections for a breakdown of training time.

A ``SectionTimer`` sums the seconds spent in each named section.  With
``cuda=True`` it synchronises the card on entering and leaving a
section, so device work is charged to the section that queued it — the
synchronisation itself slows the run, so the trainer keeps no timer
unless a caller sets one (``GBDT.timer``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class SectionTimer:
    def __init__(self, cuda: bool = False):
        self.cuda = cuda
        self.seconds = defaultdict(float)

    def _sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def section(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] += time.perf_counter() - t0

