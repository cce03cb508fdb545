"""chip_smoke.py's ``parallel`` phase alone, on one CUDA card.

Run from the repository root, on the card:

    python3 -m scripts.chip_parallel_phase [--seed 0]

Writes what the phase reads into a temporary directory (the SD1.5
diffusers directory with random bf16 VAE and CLIP weights, 24 PNGs and
their cache at 512^2), checks splash at the tensor-parallel form
``chip_smoke.PARALLEL_TP_SHAPE`` against its plain version, then runs
``chip_smoke.parallel_phase``: the single process, the train CLI on one
rank over NCCL, NCCL's refusal of two ranks on one card, two ranks over gloo
in each mesh of ``chip_smoke.PARALLEL_MESHES`` and the planted fault
``chip_smoke.PARALLEL_FAULT``, each held to the phase's bounds. Prints the
card's name and power limit and one summary line per run, and writes
parallel_phase.json into chip_smoke.py's output directory
(``chip_smoke.OUT_DIR``). Exits non-zero if a check fails.
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
from scal_sdt_tpu_torch.cli import cache as cache_cli


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
    tmp = Path(tempfile.mkdtemp(prefix="parallel_phase_"))
    try:
        vae_config, clip_config = cs.VAEConfig.sd15(), cs.CLIPTextConfig.vit_l()
        frozen = {
            **{f"vae.{k}": v.bfloat16()
               for k, v in cs.init_vae_params(vae_config, args.seed + 2, "cuda").items()},
            **{f"condition_model.encoder.{k}": v.bfloat16()
               for k, v in cs.init_clip_params(clip_config, args.seed + 3, "cuda").items()}}
        model = cs.write_model_dir(tmp, args.seed, frozen)
        del frozen
        images = cs.write_images(tmp, 24, args.seed)
        cfg = {"model": str(model), "seed": args.seed, "num_workers": cs.NUM_WORKERS,
               "data": {"resolution": cs.RESOLUTION, "cache": str(tmp / "cache.safetensors"),
                        "concepts": [{"instance_set": {"path": str(images),
                                                       "prompt": "{TXT_PROMPT}"}}]}}
        (tmp / "cache.yaml").write_text(json.dumps(cfg))
        cache_cli.main(["--config", str(tmp / "cache.yaml"), "--batch-size", "8",
                        "--aug-group-size", "1"], standalone_mode=False)
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        kernel = cs.kernel_phase(cs.PARALLEL_TP_SHAPE, gen, cs.exp_rate())
        t1 = time.perf_counter()
        res = cs.parallel_phase(args.seed, tmp, model, tmp / "cache.safetensors")
        res["seconds"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res.update(card=smi, setup_s=setup_s, kernel=kernel,
               total_s=time.perf_counter() - t0)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "parallel_phase.json").write_text(json.dumps(res, indent=1, default=str))
    print(f"splash {kernel['shape']}: "
          f"{json.dumps({k: v for k, v in kernel.items() if k != 'shape'})}")
    s1 = res["single"]
    print(f"single: {s1['steps_per_s']} steps/s, peak {s1['peak_mem_gib']:.2f} GiB, "
          f"losses {list(s1['losses'].values())}")
    c = res["cli_nccl_1"]
    print(f"cli 1 rank {c['backend']}: {c['steps_per_s']} steps/s, check {c['check']}")
    for mesh in cs.PARALLEL_MESHES:
        for r in res["x".join(map(str, mesh))]:
            print(f"mesh {tuple(r['mesh'])} rank {r['rank']}: {r['steps_per_s']} steps/s, "
                  f"peak {r['peak_mem_gib']:.2f} GiB, state {r['state_gib']:.2f} GiB, "
                  f"losses {r['losses']}, check {r['check']}")
    print(f"fault {res['fault']['name']}: {res['fault']['check']}")
    print(f"phase {res['seconds']:.1f} s, setup {setup_s:.1f} s, total {res['total_s']:.1f} s "
          f"({smi})")


if __name__ == "__main__":
    main()
