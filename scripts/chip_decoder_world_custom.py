"""chip_smoke.py's native-decoder, tuner-world and Custom Diffusion phases
alone, on one CUDA card.

Run from the repository root, on the card:

    python3 -m scripts.chip_decoder_world_custom [--seed 0] [--steps 5] [--skip-uncached]

Builds the kernels, then runs ``chip_smoke.uncached_phase`` (which fails
unless the images decode through the native decoder), its ``decoder_leg``
(one epoch and 3 steps with the native decoder and with PIL on the same
PNGs) and ``cache_phase``; writes the SD1.5 directory from the uncached
phase's VAE and CLIP; then ``tuner_world_phase`` (the tuner over a 2-rank
gloo world sharing the card) and ``custom_diffusion_phase`` (BASELINE
workload 5: train, prune to fp16, reload). ``--skip-uncached`` writes the
directory from random VAE and CLIP weights and a cache of seeded rows in
place of the first three phases. Prints the card's name and power limit
with each phase's line and writes decoder_world_custom.json into
chip_smoke.py's output directory. Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs


def uncached_legs(args, tmp: Path, per_step: dict, out: dict, smi: str) -> dict:
    """The uncached phase, its decoder leg and the cache phase (which writes
    ``tmp/cache.safetensors``); returns the frozen VAE and CLIP."""
    uncached = cs.uncached_phase(args.seed, args.steps, tmp, per_step)
    decoders = cs.decoder_leg(uncached)
    cache = cs.cache_phase(uncached, tmp, uncached["per_step"])
    out["uncached"] = {k: uncached[k] for k in ("steps_per_s", "peak_mem_gib", "vae_ms",
                                                 "clip_ms", "losses", "launches")}
    out["decoders"], out["cache"] = decoders, cache
    print(f"uncached ({decoders['active']}, {decoders['build']} build; {smi}): "
          f"{uncached['steps_per_s']:.4f} steps/s; native {decoders['native']}; PIL "
          f"{decoders['pil']}; cache {cache['images_per_s']:.2f} images/s", flush=True)
    return uncached["frozen"]


def random_frozen(seed: int) -> dict:
    return {**{f"vae.{k}": v.bfloat16() for k, v in cs.init_vae_params(
                cs.VAEConfig.sd15(), seed + 2, "cuda").items()},
            **{f"condition_model.encoder.{k}": v.bfloat16() for k, v in cs.init_clip_params(
                cs.CLIPTextConfig.vit_l(), seed + 3, "cuda").items()}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--skip-uncached", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    cs._build.load_library()
    per_step = {name: cs.CALLS_PER_STEP for name in cs.SPLASH}
    out: dict = {"card": smi}
    tmp = Path(tempfile.mkdtemp(prefix="decoder_world_custom_"))
    try:
        if args.skip_uncached:
            frozen = random_frozen(args.seed)
            cs.write_row_cache(tmp / "cache.safetensors", cs.UNCACHED_IMAGES, args.seed)
        else:
            frozen = uncached_legs(args, tmp, per_step, out, smi)
        gc.collect()
        torch.cuda.empty_cache()
        model = cs.write_model_dir(tmp, args.seed, frozen)
        del frozen
        gc.collect()
        torch.cuda.empty_cache()
        world = cs.tuner_world_phase(args.seed, tmp, model, {
            **per_step, "adam_bf16_fused": cs.ADAM_PER_STEP, "adam8_fused": 0, "ema_fused": 0})
        out["tuner_world"] = world
        for t in world["trials"]:
            print(f"tuner world trial ({smi}): {json.dumps(t)}", flush=True)
        ranks = [(r["batch_size"], r["losses"], r["steps_per_s"], r["peak_mem_gib"])
                 for r in world["ranks"]]
        print(f"tuner world: picked {world['picked']}; per rank (batch, losses, steps/s, peak "
              f"GiB) {ranks}; phase {world['seconds']:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        out["custom_diffusion"] = cs.custom_diffusion_phase(args.seed, tmp, model,
                                                            tmp / "cache.safetensors")
        print(f"custom diffusion ({smi}): {json.dumps(out['custom_diffusion'])}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        out["total_s"] = time.perf_counter() - t0
        cs.OUT_DIR.mkdir(exist_ok=True)
        (cs.OUT_DIR / "decoder_world_custom.json").write_text(
            json.dumps(out, indent=1, default=str))
    print(f"total {out['total_s']:.1f} s ({smi})")


if __name__ == "__main__":
    main()
