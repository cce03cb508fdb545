"""The optimizer and EMA kernels' merged launches in the forms the trainer
runs them, on one CUDA card, without the rest of chip_smoke.py.

Run from the repository root, on the card:

    python3 -m scripts.chip_optim_groups

Builds the kernels, then times and checks bit for bit against their plain
versions (chip_smoke.py's cases, the same bounds):

* lora.yaml's 264 LoRA groups at SD1.5 width: ``adam_bf16_fused`` as the
  run's optimizer launches it (one launch over every group, each with its
  lr and decay), and ``ema_fused`` in one launch over the 384 UNet factors
  with fp32 and bf16 shadows (``chip_smoke.lora_kernel_case``);
* sdxl_lora.yaml's 986 groups at SDXL-base's widths
  (``chip_smoke.sdxl_kernel_case``);
* the 686 SD1.5 leaves: AdamW's grouped launch (bf16 masters and moments)
  and ``ema_fused`` with both shadows (``chip_smoke.adamw_group_case``,
  ``ema_kernel_case``).

Prints one line per form with the launch's device ms, its ms by CUDA
events, the optimizer step's host ms, the bytes bound and the library call,
each line with the card's name and power limit, and writes
chiprun_out/chip_optim_groups.json.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

import chip_smoke as cs


def _line(name: str, r: dict, smi: str) -> str:
    keys = ("launches", "ms", "call_ms", "host_ms", "plain_ms", "bound", "library_ms", "err",
            "bit_equal", "leaves", "elements", "chunks")
    return f"{name} ({smi}): " + json.dumps({k: r[k] for k in keys if k in r})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_optim_groups: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs._build.load_library()
    cs.OUT_DIR.mkdir(exist_ok=True)
    for line in cs.ptxas_lines(cs._build.build_log):
        if "adam" in line or "ema" in line:
            print(line, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}

    out["lora"] = cs.lora_kernel_case(gen)
    print(_line(f"lora adam_bf16_fused, {out['lora']['groups']} groups",
                out["lora"]["adam_bf16_fused"], smi), flush=True)
    for name, r in out["lora"]["ema_fused"].items():
        print(_line(f"lora ema_fused, {name} shadows", r, smi), flush=True)
    torch.cuda.empty_cache()

    out["sdxl"] = cs.sdxl_kernel_case(gen)
    print(_line(f"sdxl adam_bf16_fused, {out['sdxl']['groups']} groups",
                out["sdxl"]["adam_bf16_fused"], smi), flush=True)
    torch.cuda.empty_cache()

    keys, shapes = cs.sd15_leaves()
    out["sd15_adamw"] = cs.adamw_group_case(gen, keys, shapes)
    print(_line("sd15 adam_bf16_fused, 686 leaves", out["sd15_adamw"], smi), flush=True)
    torch.cuda.empty_cache()
    out["sd15_ema"] = {}
    for name, dt in cs.EMA_DTYPES.items():
        out["sd15_ema"][name] = cs.ema_kernel_case(gen, keys, shapes, dt)
        print(_line(f"sd15 ema_fused, {name} shadows", out["sd15_ema"][name], smi), flush=True)
        torch.cuda.empty_cache()
    (cs.OUT_DIR / "chip_optim_groups.json").write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
