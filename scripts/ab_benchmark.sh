#!/usr/bin/env bash
# Alternate `benchmark/run.py` over source trees on one card, to compare
# versions on one machine in one run:
#
#   scripts/ab_benchmark.sh OUT_DIR TREE [TREE ...] [-- RUN_PY_ARGS ...]
#
# e.g. scripts/ab_benchmark.sh build/ab ab/P ab/C ab/C ab/P ab/P ab/C
#      scripts/ab_benchmark.sh build/ab ab/P ab/C -- \
#          --cells benchmark/cells_left_out.json --workload bending128_j2_mg
#
# Each TREE is a checkout (or `git archive` unpacked) holding benchmark/;
# the arms run in the order given, each from its own tree, so each builds and
# loads its own kernels.  Arm n writes OUT_DIR/<n><label>/result.json and
# OUT_DIR/<n><label>.log (label: the tree's directory name) and prints one
# line per cell: step_s, peak, ksp_solve_s, the profiled step's idle share,
# device ops and busy ms, K1's profiled ms and launches, rows and KSP its.
# GC_T0=N sets the first threshold of Python's cyclic collector in every
# process of the arms (scripts/gc_site/sitecustomize.py).  Exits non-zero if
# an arm fails or a cell is not correct.
set -uo pipefail

root=$(cd "$(dirname "$0")/.." && pwd)
out=$(mkdir -p "$1" && cd "$1" && pwd)
shift
trees=()
while [[ $# -gt 0 && $1 != "--" ]]; do
    trees+=("$1")
    shift
done
[[ $# -gt 0 ]] && shift
site=()
[[ -n ${GC_T0:-} ]] && site=(env "PYTHONPATH=$root/scripts/gc_site")
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
n=0
for tree in "${trees[@]}"; do
    n=$((n + 1))
    tag=$n$(basename "$(cd "$tree" && pwd)")
    t0=$(date +%s)
    (cd "$tree" && "${site[@]}" python3 benchmark/run.py --out-dir "$out/$tag" "$@") \
        > "$out/$tag.log" 2>&1
    rc=$?
    echo "=== arm $tag: $tree, exit code $rc, $(( $(date +%s) - t0 )) s"
    [[ $rc -ne 0 ]] && status=1
    python3 - "$tag" "$out/$tag/result.json" <<'PY'
import json
import sys

tag, path = sys.argv[1:]
try:
    workloads = json.load(open(path))["workloads"]
except (OSError, ValueError, KeyError) as e:
    sys.exit(f"{tag}: no result ({e})")
for name, w in workloads.items():
    L = w.get("layers", {})
    print(tag, name, "correct", w.get("correct"), "step_s", w.get("step_s"),
          "peak", w.get("peak_mem_gib"), "ksp_solve_s", L.get("ksp_solve_s"),
          "idle", L.get("device_idle_share"), "ops", L.get("device_ops"),
          "busy_ms", L.get("device_busy_ms"), "k1", L.get("profiled_k1_ms_count"),
          "k1_launches", L.get("k1_launches"), "row_dev", w.get("max_row_dev"),
          "its", json.dumps(L.get("ksp_its"))[:160], flush=True)
PY
done
exit $status
