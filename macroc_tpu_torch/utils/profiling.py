"""Named wall-clock phases with device synchronisation (the torch form of
``macroc_tpu.utils.profiling.PhaseTimer``).

CUDA work is asynchronous: a host clock around it measures the enqueue.
Each phase therefore synchronises the device on entry and on exit, so the
time it books is the device work issued inside it.  Nested phases are
allowed (an outer phase includes its inner ones)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class PhaseTimer:
    def __init__(self, device: torch.device):
        self.sync = device.type == "cuda"
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase                   total_s      calls    mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<22} {t:>9.3f} {c:>10d} {t / c * 1e3:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def no_phase(name: str) -> Iterator[None]:
    """Stand-in for PhaseTimer.phase when phases are not logged."""
    yield
