#!/usr/bin/env bash
# Two whole steps of chip_smoke.py in two trees, one process per run, in
# turns parent, change, change, parent (repeated `pairs` / 2 times): the
# cached SD1.5 train phase (512^2, batch 8, bf16 moments, 3 warm-up and 10
# timed steps) and the cached SD3 step (SD3-Medium, 1024^2, batch 2, 2
# warm-up and 5 timed steps). Prints "<side> <phase> <steps/s> <peak GiB>"
# per run, and the card's name and power limit first.
#
# Run on the card from the change's root, with the parent unpacked into a
# directory that .gitignore lists:
#   git archive <parent> | tar -x -C tree_check/parent
#   bash scripts/ab_step_phases.sh tree_check/parent [pairs]
set -u
parent=$1
pairs=${2:-2}
one() {  # side dir
  (cd "$2" && python3 -c "
import torch
import chip_smoke as c
r = c.train_phase(0, 10, 'adamw', {n: c.CALLS_PER_STEP for n in c.SPLASH})
print('$1 sd15_train', r['steps_per_s'], r['peak_mem_gib'], flush=True)
del r
torch.cuda.empty_cache()
gen = torch.Generator(device='cuda').manual_seed(0)
r = c.sd3_cached_phase(0, 5, gen)
print('$1 sd3_cached', r['steps_per_s'], r['peak_mem_gib'], flush=True)
" 2>&1 | grep -E "^$1 ")
}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for i in $(seq 1 "$pairs"); do
  if [ $((i % 2)) = 1 ]; then one parent "$parent"; one change .
  else one change .; one parent "$parent"; fi
done
