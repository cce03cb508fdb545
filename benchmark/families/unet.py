"""The SD 1.x family: a conditional UNet under DDPM's epsilon objective,
conditioned on CLIP text states (B, 77, cross_attention_dim).

Both sides of one configuration file: the program's ``UNetConfig`` and
``NoiseSchedule`` built from its keys, and the plain reference's forward.
"""

from __future__ import annotations

import functools
import json

import torch

from benchmark.reference import unet as ref_unet
from benchmark.reference.numerics import Numerics

KIND = "ddpm"


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    return ref_unet.unet_shapes(cfg)


def fixed(cfg: dict) -> dict[str, torch.Tensor]:
    """Tables the configuration fixes (none: every leaf trains)."""
    return {}


def latent_shape(cfg: dict, resolution: int) -> tuple[int, int, int]:
    f = cfg["vae_scale_factor"]
    return cfg["in_channels"], resolution // f, resolution // f


def cond_shapes(cfg: dict, traffic: dict) -> dict[str, tuple[int, ...]]:
    """The cached conditioning of one row, by batch key."""
    return {"conds": (traffic["context"], cfg["cross_attention_dim"])}


def schedule(cfg: dict) -> dict:
    return {"kind": KIND, **cfg["scheduler"]}


def draw_timesteps(cfg: dict, gen: torch.Generator, batch: int, device) -> torch.Tensor:
    """Uniform integer training timesteps over [0, N)."""
    return torch.randint(0, cfg["scheduler"]["num_train_timesteps"], (batch,), generator=gen,
                         device=device)


def reference_forward(p: dict, x: torch.Tensor, t: torch.Tensor, batch: dict, cfg: dict,
                      nx: Numerics) -> torch.Tensor:
    return ref_unet.unet_forward(p, x, t, batch["conds"], cfg, nx)


@functools.lru_cache(maxsize=8)
def _forward_flops(cfg_json: str, latent_hw: int, context: int) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = json.loads(cfg_json)
    meta = torch.device("meta")
    p = {k: torch.empty(s, device=meta) for k, s in shapes(cfg).items()}
    x = torch.empty(1, cfg["in_channels"], latent_hw, latent_hw, device=meta)
    t = torch.zeros(1, dtype=torch.long, device=meta)
    ctx = torch.empty(1, context, cfg["cross_attention_dim"], device=meta)
    with FlopCounterMode(display=False) as counter:
        ref_unet.unet_forward(p, x, t, ctx, cfg, Numerics())
    return float(counter.get_total_flops())


def forward_flops(cfg: dict, resolution: int, context: int) -> float:
    """Matmul and convolution FLOPs of one sample's forward, attention's
    products included (counted on the meta device from the reference)."""
    _, h, _ = latent_shape(cfg, resolution)
    return _forward_flops(json.dumps(cfg, sort_keys=True), h, context)


def attention_calls(cfg: dict, resolution: int, context: int
                    ) -> list[tuple[int, int, int, int]]:
    """(heads, Lq, Lk, head_dim) of each self-attention of one forward (the
    cross-attentions to the ``context`` text states are left out)."""
    _, h, w = latent_shape(cfg, resolution)
    ch = cfg["block_out_channels"]
    heads = cfg["attention_head_dim"]
    calls = []
    for i, kind in enumerate(cfg["down_block_types"]):
        if kind.startswith("CrossAttn"):
            n = (h >> i) * (w >> i)
            calls += [(heads, n, n, ch[i] // heads)] * cfg["layers_per_block"]
    last = len(ch) - 1
    n = (h >> last) * (w >> last)
    calls.append((heads, n, n, ch[last] // heads))
    for i, kind in enumerate(cfg["up_block_types"]):
        level = len(ch) - 1 - i
        if kind.startswith("CrossAttn"):
            n = (h >> level) * (w >> level)
            calls += [(heads, n, n, ch[level] // heads)] * (cfg["layers_per_block"] + 1)
    return calls


# --- the program's side -----------------------------------------------------------

def program_denoiser(cfg: dict):
    from scal_sdt_tpu_torch.models.unet import UNetConfig

    return UNetConfig(in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
                      block_out_channels=tuple(cfg["block_out_channels"]),
                      layers_per_block=cfg["layers_per_block"],
                      num_attention_heads=cfg["attention_head_dim"],
                      cross_attention_dim=cfg["cross_attention_dim"],
                      down_block_types=tuple(cfg["down_block_types"]),
                      up_block_types=tuple(cfg["up_block_types"]),
                      norm_num_groups=cfg["norm_num_groups"], sample_size=cfg["sample_size"],
                      flip_sin_to_cos=cfg["flip_sin_to_cos"], freq_shift=cfg["freq_shift"])


def program_schedule(cfg: dict):
    from scal_sdt_tpu_torch.diffusion.schedule import NoiseSchedule

    s = cfg["scheduler"]
    return NoiseSchedule(num_train_timesteps=s["num_train_timesteps"],
                         beta_start=s["beta_start"], beta_end=s["beta_end"],
                         beta_schedule=s["beta_schedule"], prediction_type=s["prediction_type"],
                         steps_offset=s["steps_offset"], clip_sample=s["clip_sample"],
                         set_alpha_to_one=s["set_alpha_to_one"])


def program_step_spec(cfg: dict, config):
    from scal_sdt_tpu_torch.training.step import StepSpec

    return StepSpec.from_config(config, program_denoiser(cfg), program_schedule(cfg))
