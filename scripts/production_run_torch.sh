#!/usr/bin/env bash
# Production-run shape of macroc_tpu_torch, the reference's
# scripts/launch_jobs.sh (50x3x50 grid, 10,000 steps, dt=1e-3, micro_n=10;
# launch_jobs.sh:13-20,48-58), on one CUDA GPU (MACROC_PLATFORM=cpu: the
# CPU).  Runs the J2 closed-form engine by default; switch to the full
# micro-FE engine with -constitutive microfe (cost scales with micro_n^3 per
# GP).  The flags are those of scripts/production_run.sh.
set -euo pipefail
cd "$(dirname "$0")/.."

exec python -m macroc_tpu_torch \
    -da_grid_x 50 -da_grid_y 3 -da_grid_z 50 \
    -lx 50 -ly 1 -lz 50 \
    -ts 10000 -dt 0.001 \
    -bc_type 1 \
    -newton_max_its 4 \
    -micro_n 10 -micro_type 1 \
    -checkpoint_freq 500 \
    -log_phases \
    "$@"
