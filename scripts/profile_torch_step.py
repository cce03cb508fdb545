"""Where the PyTorch port's SD1.5 training step spends its time, on one CUDA card.

Run from the repository root, on the card:

    python3 -m scripts.profile_torch_step [--seed 0] [--steps 3] [--optimizer adamw|adamw8bit]

The workload is chip_smoke.py's train phase (SD1.5 at full width, 512^2,
batch 8, cached latents/conds, bf16 masters, no remat) with bf16 moments
(``adamw``, the default) or int8 moments (``adamw8bit``). After 3 warm-up
steps it measures:

* the step's three phases by CUDA events -- ``loss_and_grads``, the
  optimizer (``tx.update``), the master apply (``apply_updates``) -- the
  functions ``make_train_step`` chains, called one after the other;
* a ``torch.profiler`` trace of ``--steps`` whole steps: device time by kernel
  category and the top kernels, kernel launches per step, and the share of
  the wall time the device was busy;
* steps/s of the plain loop, and the card's clocks and power after it.

Prints one summary line per item and writes
chiprun_out/profile_torch_step_<optimizer>.json.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke
from scal_sdt_tpu_torch.training import step as step_mod

CATEGORIES = (  # first match wins; lower-case substrings of kernel names
    ("splash", ("splash",)),
    ("optimizer_kernels", ("adam8_fused", "adam_bf16_fused")),
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


def phase_times(setup: dict, steps: int) -> dict:
    """ms per phase, the phases of make_train_step run one after another."""
    state, spec, tx, batch = (setup[k] for k in ("state", "spec", "tx", "batch"))
    out = collections.defaultdict(float)
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        _, grads = step_mod.loss_and_grads(spec, state.trainable, {}, batch, state.generator)
        ev[1].record()
        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state, state.trainable)
            del grads
            ev[2].record()
            trainable = step_mod.apply_updates(state.trainable, updates, state.step)
            del updates
        ev[3].record()
        state = step_mod.TrainState(state.step + 1, trainable, opt_state, state.generator)
        torch.cuda.synchronize()
        for name, a, b in (("loss_and_grad", 0, 1), ("optimizer", 1, 2), ("apply", 2, 3)):
            out[name] += ev[a].elapsed_time(ev[b]) / steps
    setup["state"] = state
    return dict(out)


def profile_steps(setup: dict, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    step_fn, batch = setup["step_fn"], setup["batch"]
    state = setup["state"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step_fn(state, {}, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    setup["state"] = state
    by_cat = collections.defaultdict(float)
    by_name = collections.defaultdict(float)
    launches = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        by_cat[category(evt.name)] += us / 1e3 / steps
        by_name[evt.name] += us / 1e3 / steps
        launches += 1
    busy = sum(by_cat.values()) * steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"wall_ms_per_step_profiled": wall_ms / steps,
            "device_ms_per_step": busy / steps,
            "device_busy_share": busy / wall_ms if wall_ms else None,
            "kernel_launches_per_step": launches / steps,
            "ms_per_step_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms_per_step": [[n[:120], ms] for n, ms in top]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--optimizer", choices=sorted(OPTIMIZERS), default="adamw")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA card", file=sys.stderr)
        return 2
    setup = chip_smoke.setup_train(args.seed, OPTIMIZERS[args.optimizer])
    for _ in range(3):
        setup["state"], m = setup["step_fn"](setup["state"], {}, setup["batch"])
    m["train_loss"].item()

    result = {"device": torch.cuda.get_device_name(0), "optimizer": OPTIMIZERS[args.optimizer]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        setup["state"], m = setup["step_fn"](setup["state"], {}, setup["batch"])
    torch.cuda.synchronize()
    result["steps_per_s"] = args.steps / (time.perf_counter() - t0)
    result["smi_after_loop"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    result["phase_ms"] = phase_times(setup, args.steps)
    result["profile"] = profile_steps(setup, args.steps)
    for k, v in result.items():
        print(f"{k}: {json.dumps(v)}", flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"profile_torch_step_{args.optimizer}.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
