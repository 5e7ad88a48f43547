#!/usr/bin/env bash
# Multi-process launch of macroc_tpu_torch, one process (rank) per CUDA
# card: the counterpart of scripts/pod_run.sh and of the reference's SLURM
# generators (scripts/launch_jobs.sh, scripts/scala/gen_inputs.sh: 96-768
# MPI ranks at 100^3).  The flags are those of scripts/pod_run.sh.
#
# Start THIS SAME SCRIPT once per rank, on every host, each with the
# torch.distributed rendezvous that parallel/distributed.py reads (nothing
# is detected: all three are required once more than one rank runs):
#   MACROC_COORDINATOR=<host of rank 0>:<free port>
#   MACROC_NUM_PROCESSES=<number of ranks>
#   MACROC_PROCESS_ID=<this rank>                  (e.g. from $SLURM_PROCID)
# e.g. two ranks on one host with two cards:
#   for r in 0 1; do MACROC_COORDINATOR=localhost:29500 MACROC_NUM_PROCESSES=2 \
#       MACROC_PROCESS_ID=$r bash scripts/pod_run_torch.sh & done; wait
# Rank r runs on card r modulo the host's card count.  With a card per rank
# the ranks talk NCCL; ranks that share a card talk gloo, every collective
# staged through host memory (parallel/distributed.py::backend_for).
#
# Rank-grid placement (grid.py::decide_processor_grid): with
# MACROC_NUM_PROCESSES set, -da_processors_x is pinned to it, so the grid
# is cut into slabs along x and each rank exchanges only its two x-faces:
# ny*nz nodes * 3 dof * 4 B per direction (100^3: 120 kB per exchange); the
# collectives that matter are the CG all-reduces, latency-bound scalars.
#
# Strong-scaling sweep (the reference's scala/ harness): run this script
# with 1, 2, 4, ... ranks and the same MACROC_GRID and extract the speedup
# as gen_inputs.sh:36-42 did from the elapsed-time line:
#   t1=$(grep "Elapsed time" out_1rank.log | awk '{print $4}')
#   tn=$(grep "Elapsed time" out_Nrank.log | awk '{print $4}')
#   echo "speedup at N ranks: $(echo "$t1 / $tn" | bc -l)"
# (scripts/scaling_sweep_torch.py does the same for ranks on one machine.)
set -euo pipefail
cd "$(dirname "$0")/.."

GRID=${MACROC_GRID:-100}          # nodes per direction (scala/ used 100^3)
TS=${MACROC_TS:-10}               # time steps (scala/ used 10)
HOSTS=${MACROC_NUM_PROCESSES:-}   # optional: pin -da_processors_x to the ranks

PROC_FLAGS=()
if [[ -n "${HOSTS}" ]]; then
    PROC_FLAGS+=(-da_processors_x "${HOSTS}")
fi

exec python -m macroc_tpu_torch \
    -da_grid_x "${GRID}" -da_grid_y "${GRID}" -da_grid_z "${GRID}" \
    -lx 50 -ly 50 -lz 50 \
    -ts "${TS}" -dt 0.001 \
    -bc_type 1 -rad 10 \
    -newton_max_its 4 \
    -checkpoint_freq 0 \
    -log_phases \
    "${PROC_FLAGS[@]}" \
    "$@"
