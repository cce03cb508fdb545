#!/usr/bin/env bash
# chip_smoke.py in two trees, in turns: parent, change, change, parent (one
# process each). Each run's output goes to chiprun_out/ab_<n>_<side>.log; the
# phase lines that carry steps/s are printed after each run, with the card's
# name and power limit first.
#
# Run on the card from the change's root, with the parent unpacked into a
# directory that .gitignore lists:
#   git archive <parent> | tar -x -C tree_check/parent
#   bash scripts/ab_chip_smoke.sh tree_check/parent
set -u
parent=$1
out=$(pwd)/chiprun_out
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
n=0
for side in parent change change parent; do
  n=$((n + 1))
  dir=.
  [ "$side" = parent ] && dir=$parent
  log="$out/ab_${n}_${side}.log"
  (cd "$dir" && python3 chip_smoke.py > "$log" 2>&1)
  echo "== $n $side rc=$?"
  grep -E '^(train|int8|uncached|trainer|ema|lora|sdxl lora)[: ]' "$log" | cut -c1-200
done
