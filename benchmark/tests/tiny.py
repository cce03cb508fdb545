"""A benchmark root of tiny cells, for runs on the CPU: the real harness,
kinds, families and metric readers, beside tiny configurations, traffic
mixes and limits of their own, under a ``BENCHMARK.json`` that names them.
A new cell here is new files and entries only, as in the real benchmark."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

UNET = {
    "family": "unet", "attention_head_dim": 2, "block_out_channels": [32, 64],
    "cross_attention_dim": 32, "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "flip_sin_to_cos": True,
    "freq_shift": 0, "in_channels": 4, "out_channels": 4, "layers_per_block": 1,
    "norm_num_groups": 8, "sample_size": 8, "vae_scale_factor": 2,
    "scheduler": {"beta_start": 0.00085, "beta_end": 0.012, "beta_schedule": "scaled_linear",
                  "num_train_timesteps": 1000, "prediction_type": "epsilon", "steps_offset": 1,
                  "clip_sample": False, "set_alpha_to_one": False},
    "text_encoder": {"vocab_size": 1000, "hidden_size": 32, "intermediate_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "max_position_embeddings": 77, "hidden_act": "quick_gelu",
                     "bos_token_id": 998, "eos_token_id": 999},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [16, 32], "layers_per_block": 1, "norm_num_groups": 8,
            "scaling_factor": 0.18215},
}
MMDIT = {
    "family": "mmdit", "sample_size": 8, "patch_size": 2, "in_channels": 4, "out_channels": 4,
    "num_layers": 2, "attention_head_dim": 8, "num_attention_heads": 2,
    "joint_attention_dim": 24, "pooled_projection_dim": 20, "pos_embed_max_size": 12,
    "vae_scale_factor": 2, "scheduler": {"num_train_timesteps": 1000, "shift": 3.0},
}
TRAIN = {"kind": "train", "precision": "32", "batch": 4, "resolution": 16, "context": 7, "cache_rows": 16,
         "check_steps": 3, "trace_steps": 1, "reference_rows": 2,
         "optimizer": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                       "weight_decay": 1e-2, "master_dtype": "fp32", "moment_dtype": None}}
SAMPLE = {"kind": "sample", "dtype": "fp32", "batch": 2, "resolution": 16, "method": "ddim", "steps": 4,
          "cfg_scale": 7.5, "prompt_tokens": [2, 6], "trace_batches": 1, "reference_rows": 4}
CELLS = {  # name: (config, traffic)
    "tiny-unet-train": ("tiny-unet", "tiny-train"),
    "tiny-mmdit-train": ("tiny-mmdit", "tiny-train"),
    "tiny-unet-sample": ("tiny-unet", "tiny-sample"),
}
# the CPU runs the port's float32 path against the reference: the gaps are round-off
LIMITS = {"tiny-unet-train": {"loss": 1e-3, "grad": 1e-3, "update": 1e-2},
          "tiny-mmdit-train": {"loss": 1e-3, "grad": 1e-3, "update": 1e-2},
          "tiny-unet-sample": {"image_gap": 2e-3}}


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(root: Path, train_master: str = "fp32") -> Path:
    """A benchmark root under ``root`` holding the tiny cells."""
    for folder in ("kinds", "families", "metrics"):
        shutil.copytree(BENCH / folder, root / "benchmark" / folder)
    write(root / "benchmark/configs/tiny-unet.json", UNET)
    write(root / "benchmark/configs/tiny-mmdit.json", MMDIT)
    train = json.loads(json.dumps(TRAIN))
    train["optimizer"]["master_dtype"] = train_master
    write(root / "benchmark/traffic/tiny-train.json", train)
    write(root / "benchmark/traffic/tiny-sample.json", SAMPLE)
    for cell, limits in LIMITS.items():
        write(root / f"benchmark/limits/{cell}.json",
              {k: {"limit": v} for k, v in limits.items()})
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": n, "source": "tiny", "file": f"benchmark/configs/{n}.json",
                        "reduced": []} for n in ("tiny-unet", "tiny-mmdit")]
    spec["workloads"] = [{"name": c, "config": cfg, "traffic": tr, "chips": 1, "why": "tiny"}
                         for c, (cfg, tr) in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            train_cell = any("ft-" in w for w in m["workloads"])
            m["workloads"] = [c for c, (_, tr) in CELLS.items()
                              if (tr == "tiny-train") == train_cell]
    write(root / "BENCHMARK.json", spec)
    return root
