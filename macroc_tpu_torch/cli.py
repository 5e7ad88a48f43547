"""Command-line entry point: ``python -m macroc_tpu_torch [petsc-style flags]``.

Takes the same flags as ``python -m macroc_tpu`` (``macroc_tpu.config``).
``MACROC_PLATFORM`` picks the device: ``cuda`` (the default; raises when no
CUDA device is present) or ``cpu``, where every kernel runs its plain
PyTorch version.  Flags whose code paths are not ported yet raise.
"""

from __future__ import annotations

import os
import sys

import torch

from macroc_tpu.config import MacroConfig, parse_cli
from macroc_tpu_torch.driver import Simulation
from macroc_tpu_torch.utils.runtime import setup_runtime


def unsupported(cfg: MacroConfig) -> list:
    """The reasons this config cannot run on the port yet (empty: it can)."""
    procs = [p for p in (cfg.procs_x, cfg.procs_y, cfg.procs_z) if p is not None]
    checks = [
        (any(p > 1 for p in procs), "-da_processors_* > 1 (multi-GPU)"),
        (cfg.resume, "-resume (checkpoint/resume)"),
        (cfg.checkpoint_freq > 0, "-checkpoint_freq > 0 (checkpoint/resume)"),
        (bool(cfg.profile_dir), "-profile_dir (torch.profiler tracing)"),
        (cfg.ksp_type == "gmres", "-ksp_type gmres (GMRES)"),
        (cfg.mg_dtype == "bfloat16", "-mg_dtype bfloat16 (bf16 MG levels)"),
        (cfg.operator == "matfree", "-operator matfree (matfree operator)"),
    ]
    return [what for bad, what in checks if bad]


def device_from_env() -> torch.device:
    plat = os.environ.get("MACROC_PLATFORM", "cuda")
    if plat not in ("cuda", "cpu"):
        raise ValueError(f"MACROC_PLATFORM must be cuda or cpu, got {plat!r}")
    if plat == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: macroc_tpu_torch runs on the GPU by default; set "
            "MACROC_PLATFORM=cpu to run the plain PyTorch versions on the CPU"
        )
    return torch.device(plat)


def run(argv=None) -> dict:
    """Parse flags, run the simulation, return Simulation.run()'s result."""
    setup_runtime()
    device = device_from_env()
    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    missing = unsupported(cfg)
    if missing:
        raise NotImplementedError(
            "not ported to macroc_tpu_torch yet (ROADMAP.md lists the "
            "order): " + "; ".join(missing)
        )
    return Simulation(cfg, device).run()


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
