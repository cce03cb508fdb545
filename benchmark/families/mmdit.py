"""The SD3 family: an MMDiT under rectified flow, conditioned on cached
prompt states (B, L, joint_attention_dim) and pooled embeddings (B,
pooled_projection_dim).

Both sides of one configuration file: the program's ``MMDiTConfig`` and
``FlowSchedule`` built from its keys, and the plain reference's forward. The
sin-cos position table is fixed by the configuration and frozen.
"""

from __future__ import annotations

import torch

from benchmark.reference import mmdit as ref_mmdit
from benchmark.reference.numerics import Numerics

KIND = "flow"
FROZEN = (ref_mmdit.POS_EMBED,)


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    return ref_mmdit.mmdit_shapes(cfg)


def fixed(cfg: dict) -> dict[str, torch.Tensor]:
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    return {ref_mmdit.POS_EMBED: ref_mmdit.sincos_table(d, cfg["pos_embed_max_size"])}


def latent_shape(cfg: dict, resolution: int) -> tuple[int, int, int]:
    f = cfg["vae_scale_factor"]
    return cfg["in_channels"], resolution // f, resolution // f


def cond_shapes(cfg: dict, traffic: dict) -> dict[str, tuple[int, ...]]:
    return {"conds": (traffic["context"], cfg["joint_attention_dim"]),
            "pooled": (cfg["pooled_projection_dim"],)}


def schedule(cfg: dict) -> dict:
    return {"kind": KIND, **cfg["scheduler"]}


def draw_timesteps(cfg: dict, gen: torch.Generator, batch: int, device) -> torch.Tensor:
    """SD3's training density: u = sigmoid(N(0, 1)), sigma = shift u / (1 +
    (shift - 1) u), the model timestep sigma * N (float32)."""
    s = cfg["scheduler"]
    u = torch.sigmoid(torch.randn((batch,), generator=gen, device=device))
    shift = s["shift"]
    return shift * u / (1.0 + (shift - 1.0) * u) * s["num_train_timesteps"]


def reference_forward(p: dict, x: torch.Tensor, t: torch.Tensor, batch: dict, cfg: dict,
                      nx: Numerics) -> torch.Tensor:
    return ref_mmdit.mmdit_forward(p, x, t, batch["conds"], batch["pooled"], cfg, nx,
                                   checkpoint_blocks=True)


def forward_flops(cfg: dict, resolution: int, context: int) -> float:
    """Matmul FLOPs of one sample's forward, from the shapes: every linear
    applied to its tokens, the patchify conv, and the joint attention's two
    products over the latent and context tokens together."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    _, h, w = latent_shape(cfg, resolution)
    ps, n = cfg["patch_size"], cfg["num_layers"]
    x_tok = (h // ps) * (w // ps)
    seq = x_tok + context
    f = 2 * x_tok * d * cfg["in_channels"] * ps * ps                     # patchify
    f += 2 * (256 * d + d * d + cfg["pooled_projection_dim"] * d + d * d)  # embeddings
    f += 2 * context * cfg["joint_attention_dim"] * d                      # context_embedder
    for i in range(n):
        last = i == n - 1
        f += 2 * d * 6 * d + 2 * d * (2 if last else 6) * d               # adaLN linears
        f += 2 * seq * 3 * d * d                                           # q, k, v
        f += 2 * 2 * seq * seq * d                                         # q k^T, p v
        f += 2 * x_tok * d * d + 2 * x_tok * 8 * d * d                     # out, MLP
        if not last:
            f += 2 * context * d * d + 2 * context * 8 * d * d             # context out, MLP
    f += 2 * d * 2 * d + 2 * x_tok * d * ps * ps * cfg["out_channels"]    # norm_out, proj_out
    return float(f)


def attention_calls(cfg: dict, resolution: int, context: int
                    ) -> list[tuple[int, int, int, int]]:
    """(heads, Lq, Lk, head_dim) of each joint attention of one forward."""
    _, h, w = latent_shape(cfg, resolution)
    ps = cfg["patch_size"]
    seq = (h // ps) * (w // ps) + context
    return [(cfg["num_attention_heads"], seq, seq, cfg["attention_head_dim"])] \
        * cfg["num_layers"]


# --- the program's side -----------------------------------------------------------

def program_denoiser(cfg: dict):
    from scal_sdt_tpu_torch.models.mmdit import MMDiTConfig

    return MMDiTConfig.from_json(cfg)


def program_schedule(cfg: dict):
    from scal_sdt_tpu_torch.diffusion.flow import FlowSchedule

    s = cfg["scheduler"]
    return FlowSchedule(num_train_timesteps=s["num_train_timesteps"], shift=s["shift"])


def program_step_spec(cfg: dict, config):
    from scal_sdt_tpu_torch.training.step import StepSpec

    return StepSpec.from_config(config, None, program_schedule(cfg),
                                mmdit_config=program_denoiser(cfg))
