#!/usr/bin/env bash
# Time two checkouts' chip_smoke.py one after the other on one host.
#
#     bash scripts/port_smoke_pair.sh OUT_DIR TREE_A TREE_B
#
# Each TREE is a checkout of the repo (a `git archive` of a commit unpacked
# into a directory). Its chip_smoke.py runs from its own root, at most
# 1150 s, each line of its output prefixed by the seconds since its start
# and written to OUT_DIR/<tree's directory name>.log. Printed for each: its
# exit code, its wall seconds, its dry run's record and its last two lines.
# Needs a card.
set -u
out=$(cd "$1" && pwd)
shift
for tree in "$@"; do
  name=$(basename "$tree")
  t0=$(date +%s)
  (cd "$tree" && timeout 1150 python3 -u chip_smoke.py 2>&1 | python3 -c "
import sys, time
t0 = time.time()
for l in sys.stdin:
    sys.stdout.write(f'{time.time() - t0:7.1f} {l}'); sys.stdout.flush()
" > "$out/$name.log"; exit "${PIPESTATUS[0]}")
  echo "$name rc=$? seconds=$(( $(date +%s) - t0 ))"
  grep -a "dryrun: " "$out/$name.log" | cut -c1-200
  tail -2 "$out/$name.log" | cut -c1-200
done
