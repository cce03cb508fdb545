"""The readings that a cell's correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [--first-seed <s>]
        [--control-seeds <m>] [--faults half_batch unchanged altered]
        [--seconds <s>] [--out chiprun_out/calibrate_<cell>.jsonl]

In one process: the program's numbers on ``--seeds`` seeds (full runs of the
cell with a window of ``--seconds``), the control's on ``--control-seeds``
(the plain reference in float8 operands put in the program's place, against
the float32 reference on the same inputs), and each planted fault's
(``runner.run_cell`` with the fault) on as many seeds as the control. One
JSON line per reading goes to ``--out`` as it comes, and a summary last: the
largest program reading and the smallest control and fault reading of each
number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_011)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.runner import make_work, run_cell
    from benchmark.harness.spec import resolve
    from benchmark.reference.numerics import Numerics, no_tf32

    cell = resolve(args.workload, ROOT)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = Path(args.out or ROOT / "chiprun_out" / f"calibrate_{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    readings: dict[str, list] = {"program": [], "control": []}

    def emit(record):
        with out.open("a") as f:
            f.write(json.dumps(record) + "\n")
        print(json.dumps(record), flush=True)

    def free():
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for seed in seeds:
        t0 = time.perf_counter()
        try:
            r = run_cell(cell, seed, args.seconds, False, device)
        except Exception as e:  # one seed's failure is a reading too; go on
            emit({"what": "program", "seed": seed, "error": repr(e)[:2000]})
            free()
            continue
        readings["program"].append(r["readings"])
        emit({"what": "program", "seed": seed, "readings": r["readings"],
              "correct": r["correct"], "metrics": r["metrics"], "phases_s": r["phases_s"],
              "explain": r.get("explain"),
              "s": time.perf_counter() - t0})
        free()
    for i in range(args.control_seeds):
        seed = seeds[i]
        t0 = time.perf_counter()
        work, _ = make_work(cell, seed, device)
        work.control_inputs()
        with no_tf32():
            prog = work.reference_readings(Numerics("fp8"))
            ref = work.reference_readings(Numerics("fp32"))
        numbers = work.numbers(prog, ref)
        readings["control"].append(numbers)
        emit({"what": "control", "seed": seed, "readings": numbers,
              "s": time.perf_counter() - t0})
        del work
        free()
    for fault in args.faults:
        readings[fault] = []
        for seed in seeds[:max(args.control_seeds, 1)]:
            r = run_cell(cell, seed, args.seconds, False, device, fault=fault)
            readings[fault].append(r["readings"])
            emit({"what": fault, "seed": seed, "readings": r["readings"],
                  "correct": r["correct"]})
            free()
    summary = {}
    for what, rows in readings.items():
        if rows:
            pick = max if what == "program" else min
            summary[what] = {k: pick(row[k] for row in rows) for k in rows[0]}
    emit({"what": "summary", "largest program, smallest others": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
