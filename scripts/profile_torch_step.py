"""Where the PyTorch port's SD1.5 training step spends its time, on one CUDA card.

Run from the repository root, on the card:

    python3 -m scripts.profile_torch_step [--seed 0] [--steps 3] [--optimizer adamw|adamw8bit]
                                          [--uncached]

The workload is chip_smoke.py's train phase (SD1.5 at full width, 512^2,
batch 8, cached latents/conds, bf16 masters, no remat) with bf16 moments
(``adamw``, the default) or int8 moments (``adamw8bit``); with
``--uncached``, its uncached phase's step (VAE encode and CLIP inside the
step, CFG dropout; bf16 moments) on one batch of its pipeline, held fixed so
that image decoding stays out of the numbers. After 3 warm-up steps it
measures:

* a ``torch.profiler`` trace of ``--steps`` whole steps with the port's spans
  on (``scal_sdt_tpu_torch/utils/tracing.py``), read by the benchmark's
  reader (``benchmark/harness/spans.py``): each span's count and device ms
  per step (``train.cast``, ``train.forward``, ``train.backward``,
  ``train.optimizer``, the attention calls by path, ...), device time by
  kernel category and the top kernels, device operations per step, and the
  share of the wall time the device was busy;
* steps/s of the plain loop, and the card's clocks and power after it.

Prints one summary line per item and writes
profile_torch_step_<optimizer>[_uncached].json into chip_smoke.py's output
directory (``chip_smoke.OUT_DIR``).
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke

CATEGORIES = (  # first match wins; lower-case substrings of kernel names
    ("splash", ("splash",)),
    ("optimizer_kernels", ("adam8_", "adam_bf16_")),
    ("optimizer_foreach", ("foreach", "multi_tensor")),
    ("conv", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas", "matmul")),
    ("norm", ("norm",)),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "fill", "cat")),
)


OPTIMIZERS = {"adamw": "adamw", "adamw8bit": "bitsandbytes.optim.AdamW8bit"}


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def profile_steps(setup: dict, steps: int) -> dict:
    from benchmark.harness import spans

    step_fn, batch, frozen = setup["step_fn"], setup["batch"], setup["frozen"]

    def unit():
        setup["state"], _ = step_fn(setup["state"], frozen, batch)

    traced = spans.record(unit, steps)
    wall_ms = (traced.window[1] - traced.window[0]) * 1e3
    by_cat = collections.defaultdict(float)
    by_name = collections.defaultdict(float)
    for op, _ in traced.ops:
        by_cat[category(op.name)] += op.dur * 1e3 / steps
        by_name[op.name] += op.dur * 1e3 / steps
    busy = sum(by_cat.values()) * steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"wall_ms_per_step_profiled": wall_ms / steps,
            "device_ms_per_step": busy / steps,
            "device_busy_share": busy / wall_ms if wall_ms else None,
            "device_ops_per_step": len(traced.ops) / steps,
            "span_device_ms_per_step": {name: [n / steps, d * 1e3 / steps]
                                        for name, (n, d) in traced.table().items()},
            "ms_per_step_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms_per_step": [[n[:120], ms] for n, ms in top]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--optimizer", choices=sorted(OPTIMIZERS), default="adamw")
    parser.add_argument("--uncached", action="store_true",
                        help="profile the uncached step (VAE and CLIP inside it)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA card", file=sys.stderr)
        return 2
    if args.uncached and args.optimizer != "adamw":
        parser.error("--uncached runs with the adamw optimizer only")
    with tempfile.TemporaryDirectory(prefix="profile_torch_step_") as tmp:
        if args.uncached:
            setup = chip_smoke.setup_uncached(args.seed, Path(tmp))
            setup["batch"] = next(chip_smoke.epochs(setup.pop("pipeline")))
        else:
            setup = chip_smoke.setup_train(args.seed, OPTIMIZERS[args.optimizer])
            setup["frozen"] = {}
    for _ in range(3):
        setup["state"], m = setup["step_fn"](setup["state"], setup["frozen"], setup["batch"])
    m["train_loss"].item()

    result = {"device": torch.cuda.get_device_name(0), "optimizer": OPTIMIZERS[args.optimizer],
              "uncached": args.uncached}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        setup["state"], m = setup["step_fn"](setup["state"], setup["frozen"], setup["batch"])
    torch.cuda.synchronize()
    result["steps_per_s"] = args.steps / (time.perf_counter() - t0)
    result["smi_after_loop"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    result["profile"] = profile_steps(setup, args.steps)
    for k, v in result.items():
        print(f"{k}: {json.dumps(v)}", flush=True)
    out = chip_smoke.OUT_DIR
    out.mkdir(exist_ok=True)
    name = f"profile_torch_step_{args.optimizer}{'_uncached' if args.uncached else ''}.json"
    (out / name).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
