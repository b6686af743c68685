#!/usr/bin/env bash
# Parent against change on one card, in one run: chip_smoke.py of an
# unpacked parent tree and of this tree in turns (parent, change, change,
# parent), each a process of its own, every output kept under OUT_DIR
# (default compare_out/ of the directory it is started from). Each further
# argument names a script of this tree that times any checkout from the
# current directory (chip_merge_fbank.py, chip_train_kernels.py): it runs
# from the same checkout right after each chip_smoke.py.
#
#   git archive <parent> | tar -x -C _checkout/parent   # a gitignored dir
#   bash chip_compare.sh _checkout/parent [OUT_DIR [SCRIPT ...]]   # on the H100 machine
#
# Exits nonzero if any run fails.
set -u
parent=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")" && pwd)
out=$(mkdir -p "${2:-compare_out}" && cd "${2:-compare_out}" && pwd)
shift $(( $# < 2 ? $# : 2 ))
rc=0
for run in parent change change2 parent2; do
  case $run in parent*) dir=$parent ;; *) dir=$here ;; esac
  (cd "$dir" && timeout 600 python3 chip_smoke.py >"$out/$run.out" 2>"$out/$run.err")
  code=$?
  echo "$run: rc $code; $(tail -n 1 "$out/$run.out")"
  [ $code -eq 0 ] || rc=1
  for script in "$@"; do
    name=$(basename "$script" .py)
    (cd "$dir" && timeout 600 python3 "$here/$script" >"$out/$run.$name.out" 2>"$out/$run.$name.err")
    code=$?
    echo "$run $name: rc $code; $(head -n 1 "$out/$run.$name.out")"
    [ $code -eq 0 ] || rc=1
  done
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $rc
