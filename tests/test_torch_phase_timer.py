"""The port's phase timer (``macroc_tpu_torch/utils/profiling.py::PhaseTimer``,
the CLI's -log_phases table): seconds and calls per phase and, on a CUDA
device, the device-memory high-water mark where a phase raised it.  The
CUDA calls are replaced by a scripted allocator, so this runs on the CPU."""

import torch

from macroc_tpu_torch.utils import profiling

GIB = 2 ** 30


class _Allocator:
    """``torch.cuda``'s synchronize and max_memory_allocated over a
    high-water mark that the test raises by hand."""

    def __init__(self, monkeypatch):
        self.high = 0
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: self.high)


def test_the_phase_that_raised_the_high_water_mark_books_it(monkeypatch):
    mem = _Allocator(monkeypatch)
    timer = profiling.PhaseTimer(torch.device("cuda"))
    with timer.phase("time_step"):
        with timer.phase("residual"):
            with timer.phase("homogenize"):
                mem.high = 4 * GIB
        with timer.phase("assembly"):
            mem.high = 6 * GIB
        with timer.phase("ksp_solve"):
            pass                      # below the mark: books nothing
    with timer.phase("time_step"):
        with timer.phase("homogenize"):
            mem.high = 7 * GIB        # a later call sets a new mark
    assert timer.peaks == {"homogenize": 7 * GIB, "residual": 4 * GIB,
                           "assembly": 6 * GIB, "time_step": 7 * GIB}
    assert timer.counts["homogenize"] == 2 and timer.counts["time_step"] == 2
    rows = {line.split()[0]: line.split() for line in timer.report().splitlines()}
    assert rows["phase"][-1] == "peak_gib"
    assert rows["assembly"][-1] == "6.0000" and rows["ksp_solve"][-1] == "-"


def test_a_cpu_timer_reads_no_device_memory(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU timer called torch.cuda")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", refuse)
    timer = profiling.PhaseTimer(torch.device("cpu"))
    with timer.phase("residual"):
        pass
    assert timer.peaks == {} and timer.counts["residual"] == 1
    assert [len(line.split()) for line in timer.report().splitlines()] == [4, 4]
