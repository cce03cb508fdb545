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

* the step's two phases -- ``loss_and_grads`` and the fused optimizer and
  master apply (``tx.update_and_apply``), the functions ``make_train_step``
  chains, called one after the other -- by CUDA events and by the host's
  clock (each phase ends in a synchronize, so the two clocks agree up to
  the launch of the first kernel), with the optimizer kernels' launches
  per step;
* a ``torch.profiler`` trace of ``--steps`` whole steps: device time by kernel
  category and the top kernels, kernel launches per step, and the share of
  the wall time the device was busy;
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
from scal_sdt_tpu_torch.training import step as step_mod

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


def phase_times(setup: dict, steps: int) -> dict:
    """ms per phase (device clock by CUDA events, host clock), the phases of
    make_train_step run one after another, and the optimizer kernels'
    launches per step."""
    state, spec, tx, batch, frozen = (setup[k] for k in ("state", "spec", "tx", "batch",
                                                          "frozen"))
    out = collections.defaultdict(float)
    chip_smoke.reset_launches()
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        _, grads = step_mod.loss_and_grads(spec, state.trainable, frozen, batch,
                                           state.generator)
        ev[1].record()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            opt_state = tx.update_and_apply(grads, state.opt_state, state.trainable, state.step)
            del grads
        ev[2].record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state = step_mod.TrainState(state.step + 1, state.trainable, opt_state, state.generator)
        for name, a, b, ta, tb in (("loss_and_grad", 0, 1, t0, t1),
                                   ("optimizer_and_apply", 1, 2, t1, t2)):
            out[name] += ev[a].elapsed_time(ev[b]) / steps
            out[name + "_host"] += (tb - ta) * 1e3 / steps
    setup["state"] = state
    launches = chip_smoke.read_launches()
    out["optimizer_launches_per_step"] = {k: launches[k] / steps
                                          for k in ("adam8_fused", "adam_bf16_fused")}
    return dict(out)


def profile_steps(setup: dict, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    step_fn, batch, frozen = setup["step_fn"], setup["batch"], setup["frozen"]
    state = setup["state"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step_fn(state, frozen, batch)
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
    result["phase_ms"] = phase_times(setup, args.steps)
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
