#!/usr/bin/env bash
# The cached train phase of chip_smoke.py (SD1.5, 512^2, batch 8, bf16
# moments, or the int8 phase's AdamW8bit when the third argument names it;
# 3 warm-up and 10 timed steps) in two trees, in separate
# processes, pair after pair with the order alternating: parent, change;
# change, parent; ... Prints "<side> <steps/s> <peak GiB> <last loss>" per
# run, and the card's name, power limit and clocks before and after.
#
# Run on the card from the change's root, with the parent unpacked into a
# directory that .gitignore lists:
#   git archive <parent> | tar -x -C tree_check/parent
#   bash scripts/ab_train_phase.sh tree_check/parent [pairs] [optimizer]
set -u
parent=$1
pairs=${2:-10}
optimizer=${3:-adamw}
one() {  # side dir
  (cd "$2" && python3 -c "
import chip_smoke as c
r = c.train_phase(0, 10, '$optimizer', {n: c.CALLS_PER_STEP for n in c.SPLASH})
print('$1', r['steps_per_s'], r['peak_mem_gib'], r['losses'][-1], flush=True)
" 2>&1 | tail -1)
}
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
for i in $(seq 1 "$pairs"); do
  if [ $((i % 2)) = 1 ]; then one parent "$parent"; one change .
  else one change .; one parent "$parent"; fi
done
nvidia-smi --query-gpu=name,clocks.sm,power.draw,power.limit --format=csv,noheader
