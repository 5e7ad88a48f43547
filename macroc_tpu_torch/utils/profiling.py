"""Named wall-clock phases with device synchronisation and a profiler
trace (the torch forms of ``macroc_tpu.utils.profiling.PhaseTimer`` and
``trace``), the repeated timings of the bench entry points (``Timings``),
and what every measurement script shares: the card's description, a
guarded configuration, the JSON record and headline (``finish``), and the
repo's scripts loaded as modules (``load_script``).

CUDA work is asynchronous: a host clock around it measures the enqueue.
Each phase therefore synchronises the device on entry and on exit, so the
time it books is the device work issued inside it.  Nested phases are
allowed (an outer phase includes its inner ones)."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import time
import traceback
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_description(device) -> str:
    """The card's name and power limit as nvidia-smi gives them (the CPU's
    name is just "cpu")."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[device.index or 0]


def guarded(name: str, fn: Callable, failures: List[str]):
    """``fn()``; when it raises, its traceback and a ``FAILED`` line are
    printed, ``name`` is added to ``failures`` and None is returned, so a
    script goes on with its other configurations."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - report it, go on with the next one
        traceback.print_exc()
        print(f"{name}: FAILED: {str(e)[-300:]}", flush=True)
        failures.append(name)
        return None


def finish(out_path: str, record: dict, headline: dict, failures: list, device) -> int:
    """A measurement script's end: ``record`` with the device's description,
    the torch and CUDA versions and ``failures`` written as JSON to
    ``out_path``; ``headline`` with the failures, the device and the path
    printed as the last line; returns the exit code, 1 if anything
    failed."""
    dev = device_description(device)
    record = dict(record, device=dev, torch=torch.__version__, cuda=torch.version.cuda,
                  failures=failures)
    out_path = os.path.abspath(out_path)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(dict(headline, failures=failures, device=dev, out=out_path)), flush=True)
    return 1 if failures else 0


def load_script(name: str):
    """scripts/``name``.py (one of the port's scripts) as a module."""
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Timings:
    """Repeated timings of one device, each recorded under its label with
    its median, relative spread and samples (``spreads``, the bench JSON's
    ``timing_spreads``).  Every timing warms up first, then takes ``reps``
    samples, in seconds per call.

    ``loop``: the device time of a call that only queues device work — CUDA
    events around ``calls`` back-to-back calls, divided by ``calls``.
    ``dispatch``: the host clock around calls that end in
    ``torch.cuda.synchronize()`` — for host-driven loops (a Newton step, a
    Krylov solve, a micro-FE homogenize).  On a CPU device both read the
    host clock; such times are never the card's."""

    def __init__(self, device, reps: int = 3):
        self.device = torch.device(device)
        self.reps = reps
        self.spreads: Dict[str, dict] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def med(self, label: Optional[str], samples) -> float:
        """The median of ``samples``, recorded under ``label`` with the
        spread (max - min) / median."""
        med = float(np.median(samples))
        if label:
            self.spreads[label] = dict(
                median=med, spread_frac=(max(samples) - min(samples)) / med if med else 0.0,
                samples=[float(s) for s in samples])
        return med

    def loop(self, fn: Callable, calls: int, label: Optional[str] = None) -> float:
        fn()
        samples = []
        for _ in range(self.reps):
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                self._sync()
                start.record()
                for _ in range(calls):
                    fn()
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end) / 1e3 / calls)
            else:
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                samples.append((time.perf_counter() - t0) / calls)
        return self.med(label, samples)

    def dispatch(self, fn: Callable, label: Optional[str] = None, calls: int = 1,
                 warm: Optional[Callable] = None) -> float:
        """``warm`` (default ``fn``) once, then ``reps`` samples of
        ``calls`` calls of ``fn`` each."""
        (warm or fn)()
        samples = []
        for _ in range(self.reps):
            self._sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            self._sync()
            samples.append((time.perf_counter() - t0) / calls)
        return self.med(label, samples)


class PhaseTimer:
    """Seconds and calls per named phase (-log_phases).  On a CUDA device it
    also keeps, per phase, the device-memory high-water mark
    (``torch.cuda.max_memory_allocated``) wherever a call of the phase
    raised it: the innermost phase with the run's largest value set the
    run's peak."""

    def __init__(self, device: torch.device):
        self.sync = device.type == "cuda"
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.peaks: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        if self.sync:
            torch.cuda.synchronize()
            high = torch.cuda.max_memory_allocated(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize()
                now = torch.cuda.max_memory_allocated(self.device)
                if now > high:
                    self.peaks[name] = max(self.peaks.get(name, 0), now)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        """The phase table, slowest first; on a CUDA device a last column,
        the high-water mark in GiB where the phase raised it (else -)."""
        lines = ["phase                   total_s      calls    mean_ms"
                 + ("   peak_gib" if self.sync else "")]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            line = f"{name:<22} {t:>9.3f} {c:>10d} {t / c * 1e3:>10.2f}"
            if self.sync:
                peak = self.peaks.get(name)
                line += f" {peak / 2**30:>10.4f}" if peak else f" {'-':>10}"
            lines.append(line)
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
