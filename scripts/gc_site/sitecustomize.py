"""Sets the first threshold of Python's cyclic collector from ``GC_T0`` in
every process that has this directory on ``PYTHONPATH``, then runs the
interpreter's own ``sitecustomize``, if there is one.  Used by
``scripts/ab_benchmark.sh`` to show which measurements move with the
collector's timing alone."""

import gc
import importlib.machinery
import importlib.util
import os
import sys

gc.set_threshold(int(os.environ["GC_T0"]), 10, 10)
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
