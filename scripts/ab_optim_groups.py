"""Time the grouped optimizer and EMA launches over the SD1.5 leaves in
several trees of this repository, in turns, on one CUDA card.

Run from the repository root, on the card, with the trees to compare (each
a checkout, e.g. a parent unpacked by ``git archive`` into a gitignored
directory):

    python3 -m scripts.ab_optim_groups tree_check/parent . . tree_check/parent

Each argument is one turn: a process started in that tree builds its own
kernels and runs its own ``chip_smoke.py`` cases over the 686 SD1.5 leaves
(``adamw_group_case``: AdamW's grouped ``adam_bf16_fused`` with bf16 masters
and moments, and in the xla mode with fp32 ones; ``ema_kernel_case`` with
fp32 and bf16 shadows), bit for bit against their plain versions, and
prints their device ms (torch.profiler) and, in a tree's first turn,
ptxas's registers of the grouped Adam's instances: one JSON line per turn
with the card's name and power limit. Writes
chiprun_out/ab_optim_groups.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

TURN = r"""
import json, torch
import chip_smoke as cs
cs._build.load_library()
gen = torch.Generator(device="cuda").manual_seed(0)
keys, shapes = cs.sd15_leaves()
# ptxas's report of the grouped Adam's instances, where this turn built them
out = {"ptxas": [l for l in cs.ptxas_lines(cs._build.build_log) if "adam_bf16_group" in l]}
for name, xla in (("adamw_bf16", False), ("adamw_xla", True)):
    r = cs.adamw_group_case(gen, keys, shapes, xla=xla)
    out[name] = {k: r[k] for k in ("ms", "call_ms", "bound", "err")}
    torch.cuda.empty_cache()
for name, dt in cs.EMA_DTYPES.items():
    r = cs.ema_kernel_case(gen, keys, shapes, dt)
    out["ema_" + name] = {k: r[k] for k in ("ms", "call_ms", "bound", "bit_equal")}
    torch.cuda.empty_cache()
print("AB " + json.dumps(out))
"""


def main(trees: list[str]) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    turns = []
    for i, tree in enumerate(trees):
        run = subprocess.run([sys.executable, "-c", TURN], cwd=tree, capture_output=True,
                             text=True, timeout=600)
        lines = [l for l in run.stdout.splitlines() if l.startswith("AB ")]
        if run.returncode != 0 or not lines:
            print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
            raise RuntimeError(f"turn {i} in {tree} failed ({run.returncode})")
        turn = {"turn": i, "tree": tree, "smi": smi, **json.loads(lines[-1][3:])}
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/ab_optim_groups.json").write_text(json.dumps(turns, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["."]))
