"""Tabular diagnostics writers — format-compatible with the reference.

These two files plus stdout ARE the reference's regression oracle
(SURVEY.md §5.5):

  info.dat (main.c:37,96-97): one row per time step,
      "%d\t%e\t%e\t%e\t%e\t%d\n" % (ts, t, U, force, f_trial_max, nl_gps)

  gauss_evolution.dat (init.c:135, util.c:77-84): one row per time step:
      time-step index then one non-linear-GP count per rank, tab-separated.
"""

from __future__ import annotations

import os
from typing import Sequence


class InfoWriter:
    def __init__(self, path: str = "info.dat", append: bool = False):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # append=True on checkpoint resume, so the file stays a complete
        # history instead of truncating to the resumed tail
        self._f = open(path, "a" if append else "w")

    def write_row(
        self,
        time_s: int,
        t: float,
        U: float,
        force: float,
        f_trial_max: float,
        nl_gps: int,
    ):
        self._f.write(
            f"{time_s}\t{t:e}\t{U:e}\t{force:e}\t{f_trial_max:e}\t{nl_gps}\n"
        )
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GaussEvolutionWriter:
    def __init__(self, path: str = "gauss_evolution.dat", append: bool = False):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a" if append else "w")

    def write_row(self, time_s: int, per_rank_counts: Sequence[int]):
        self._f.write(f"{time_s}\t")
        for c in per_rank_counts:
            self._f.write(f"{int(c)}\t")
        self._f.write("\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
