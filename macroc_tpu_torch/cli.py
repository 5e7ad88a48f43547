"""Command-line entry point: ``python -m macroc_tpu_torch [petsc-style flags]``.

Takes the same flags as ``python -m macroc_tpu`` (``config.parse_cli``).
``MACROC_PLATFORM`` picks the device: ``cuda`` (the default; raises when no
CUDA device is present) or ``cpu``, where every kernel runs its plain
PyTorch version.  ``MACROC_COORDINATOR``, ``MACROC_NUM_PROCESSES`` and
``MACROC_PROCESS_ID`` make the process one rank of a domain-decomposed run
(``parallel/distributed.py``); start one process per rank.  Every
configuration of ``python -m macroc_tpu`` runs, on one process and under N
ranks.
"""

from __future__ import annotations

import sys

import torch

from macroc_tpu_torch.config import parse_cli
from macroc_tpu_torch.driver import Simulation
from macroc_tpu_torch.parallel import distributed
from macroc_tpu_torch.utils.runtime import setup_runtime


def device_from_env() -> torch.device:
    """MACROC_PLATFORM's device for this process: the CPU, or the rank's
    card (``cuda:<rank % cards>``)."""
    plat = distributed.platform_from_env()
    if plat == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: macroc_tpu_torch runs on the GPU by default; set "
            "MACROC_PLATFORM=cpu to run the plain PyTorch versions on the CPU"
        )
    return distributed.local_device(plat)


def run(argv=None) -> dict:
    """Parse flags, run the simulation, return Simulation.run()'s result.
    Brings up the process group first when the MACROC_* environment asks
    for one, and takes it down at the end."""
    setup_runtime()
    started = distributed.maybe_initialize()
    try:
        device = device_from_env()
        cfg = parse_cli(sys.argv[1:] if argv is None else argv)
        return Simulation(cfg, device).run()
    finally:
        if started:
            distributed.shutdown()


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
