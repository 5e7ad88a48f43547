#!/usr/bin/env bash
# Alternate `chip_smoke.py --only PHASES` over source trees on one card, to
# compare versions on one machine in one run:
#
#   scripts/ab_chip_smoke.sh PHASES TREE [TREE ...]
#
# e.g. scripts/ab_chip_smoke.sh fe2 ab/parent . . ab/parent
#
# Each TREE is a checkout (or `git archive` unpacked) holding chip_smoke.py;
# the arms run in the order given, each from its own tree, so each builds and
# loads its own kernels.  Every arm's full output goes to
# $AB_LOG_DIR/ab_<n>_<tree>.log (default ab/logs); the lines of its driven runs' steps
# ("step N: ... s") and phase times are echoed with the arm's label.  Exits
# non-zero if an arm fails (chip_smoke's partial-run code 4 counts as a pass).
set -uo pipefail

phases=$1
shift
root=$(cd "$(dirname "$0")/.." && pwd)
logs=${AB_LOG_DIR:-$root/ab/logs}
mkdir -p "$logs"
status=0
n=0
for tree in "$@"; do
    n=$((n + 1))
    label=$(basename "$(cd "$tree" && pwd)")
    log="$logs/ab_${n}_${label}.log"
    echo "=== arm $n: $tree ($label)"
    (cd "$tree" && python3 chip_smoke.py --only "$phases") > "$log" 2>&1
    rc=$?
    grep -E "\] step [0-9]+:|\[time\] phase|GP/s|launches during" "$log" | sed "s/^/[arm $n $label] /"
    if [[ $rc -ne 0 && $rc -ne 4 ]]; then
        echo "=== arm $n failed with exit code $rc; last lines:"
        tail -n 20 "$log"
        status=1
    fi
done
exit $status
