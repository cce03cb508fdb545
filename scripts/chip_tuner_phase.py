"""chip_smoke.py's ``tuner`` phase alone, on one CUDA card.

Run from the repository root, on the card:

    python3 -m scripts.chip_tuner_phase [--seed 0]

Writes the SD1.5 diffusers directory the phase reads (random bf16 VAE and
CLIP weights) into a temporary directory, then runs
``chip_smoke.tuner_phase``: the train CLI with
``trainer.auto_scale_batch_size: power`` on a hub id resolved from an HF
cache written there, each trial a probe subprocess, then 2 steps at the
picked batch, held to the phase's checks. Prints the card's name and power
limit, one line per trial and a summary, and writes tuner_phase.json into
chip_smoke.py's output directory (``chip_smoke.OUT_DIR``). Exits non-zero
if a check fails.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    cs._build.load_library()
    tmp = Path(tempfile.mkdtemp(prefix="tuner_phase_"))
    try:
        frozen = {
            **{f"vae.{k}": v.bfloat16()
               for k, v in cs.init_vae_params(cs.VAEConfig.sd15(), args.seed + 2, "cuda").items()},
            **{f"condition_model.encoder.{k}": v.bfloat16()
               for k, v in cs.init_clip_params(cs.CLIPTextConfig.vit_l(), args.seed + 3,
                                               "cuda").items()}}
        model = cs.write_model_dir(tmp, args.seed, frozen)
        del frozen
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t0
        res = cs.tuner_phase(args.seed, tmp, model, {name: cs.CALLS_PER_STEP
                                                     for name in cs.SPLASH})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res.update(card=smi, setup_s=setup_s, total_s=time.perf_counter() - t0)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "tuner_phase.json").write_text(json.dumps(res, indent=1, default=str))
    for t in res["trials"]:
        print(f"trial: {json.dumps(t)}")
    print(f"picked {res['picked']} from {res['init_batch']}; losses {res['losses']}, steps/s "
          f"{res['steps_per_sec']}, peak {res['peak_mem_gib']:.2f} GiB (this process "
          f"{res['parent_reserved_gib']:.2f} GiB during the trials), launches {res['launches']}, "
          f"MFU of the last step {res['mfu_last_step']}")
    print(f"phase {res['seconds']:.1f} s, setup {setup_s:.1f} s, total {res['total_s']:.1f} s "
          f"({smi})")


if __name__ == "__main__":
    main()
