"""Named wall-clock phases with device synchronisation and a profiler
trace (the torch forms of ``macroc_tpu.utils.profiling.PhaseTimer`` and
``trace``).

CUDA work is asynchronous: a host clock around it measures the enqueue.
Each phase therefore synchronises the device on entry and on exit, so the
time it books is the device work issued inside it.  Nested phases are
allowed (an outer phase includes its inner ones)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

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


@contextlib.contextmanager
def trace(logdir: Optional[str], device: torch.device) -> Iterator[None]:
    """``torch.profiler`` over the enclosed work when ``logdir`` is given
    (-profile_dir), with CUDA activity on a CUDA device; on exit it writes a
    Chrome trace ``trace_<time>.json`` into ``logdir``.  Without a logdir it
    does nothing."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json")
    )
