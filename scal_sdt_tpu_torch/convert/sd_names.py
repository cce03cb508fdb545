"""Parameter-name helpers for Stable Diffusion checkpoints (the part of
``scal_sdt_tpu/convert/sd_names.py`` the diffusers loader and the kohya
LoRA import need).

The UNet's diffusers -> LDM prefix pairs resolve kohya LoRA files written
against LDM names; the whole LDM <-> diffusers and OpenCLIP <-> transformers
maps come with the single-file loaders and the checkpoint tools.
"""

from __future__ import annotations

import re
from typing import Iterable

import torch

from ..models.unet import UNetConfig

_VAE_ATTENTION_RENAMES = {
    ".query.": ".to_q.", ".key.": ".to_k.", ".value.": ".to_v.",
    ".proj_attn.": ".to_out.0.",
}


def normalize_df_vae_attention(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Normalize legacy diffusers VAE attention names (query/key/value/
    proj_attn) to the modern to_q/to_k/to_v/to_out.0 used internally; 1x1
    conv weights of those projections become linear (out, in) weights."""
    out = {}
    for k, v in state.items():
        for old, new in _VAE_ATTENTION_RENAMES.items():
            if old in k and "attentions" in k:
                k = k.replace(old, new)
                if k.endswith(".weight") and v.dim() > 2:
                    v = v.reshape(v.shape[0], v.shape[1])
                break
        out[k] = v
    return out


def unet_prefix_map(config: UNetConfig) -> list[tuple[str, str]]:
    """(diffusers_prefix, ldm_prefix) pairs of the UNet's modules."""
    pairs = [
        ("time_embedding.linear_1.", "time_embed.0."),
        ("time_embedding.linear_2.", "time_embed.2."),
        ("conv_in.", "input_blocks.0.0."),
        ("conv_norm_out.", "out.0."),
        ("conv_out.", "out.2."),
    ]
    if config.addition_embed_type == "text_time":
        # SDXL micro-conditioning MLP lives under label_emb in the LDM layout
        pairs += [("add_embedding.linear_1.", "label_emb.0.0."),
                  ("add_embedding.linear_2.", "label_emb.0.2.")]
    n_blocks = len(config.block_out_channels)
    lpb = config.layers_per_block

    ldm_idx = 1
    for i, btype in enumerate(config.down_block_types):
        has_attn = btype == "CrossAttnDownBlock2D"
        for j in range(lpb):
            pairs.append((f"down_blocks.{i}.resnets.{j}.", f"input_blocks.{ldm_idx}.0."))
            if has_attn:
                pairs.append((f"down_blocks.{i}.attentions.{j}.", f"input_blocks.{ldm_idx}.1."))
            ldm_idx += 1
        if i != n_blocks - 1:
            pairs.append((f"down_blocks.{i}.downsamplers.0.conv.",
                          f"input_blocks.{ldm_idx}.0.op."))
            ldm_idx += 1

    pairs.append(("mid_block.resnets.0.", "middle_block.0."))
    pairs.append(("mid_block.attentions.0.", "middle_block.1."))
    pairs.append(("mid_block.resnets.1.", "middle_block.2."))

    ldm_idx = 0
    for i, btype in enumerate(config.up_block_types):
        has_attn = btype == "CrossAttnUpBlock2D"
        for j in range(lpb + 1):
            pairs.append((f"up_blocks.{i}.resnets.{j}.", f"output_blocks.{ldm_idx}.0."))
            if has_attn:
                pairs.append((f"up_blocks.{i}.attentions.{j}.", f"output_blocks.{ldm_idx}.1."))
            if j == lpb and i != n_blocks - 1:
                # the upsampler shares the last output block; its sub-index
                # depends on whether an attention module precedes it
                sub = 2 if has_attn else 1
                pairs.append((f"up_blocks.{i}.upsamplers.0.", f"output_blocks.{ldm_idx}.{sub}."))
            ldm_idx += 1
    return pairs


def apply_renames(name: str, renames: list[tuple[str, str]]) -> str:
    for src, dst in renames:
        name = name.replace(src, dst)
    return name


def infer_unet_layout(df_names: Iterable[str]) -> UNetConfig | None:
    """The block structure a diffusers-named UNet state has (levels, layers
    per block, attention per level, text_time embedding), so the LDM prefix
    pairs index correctly for any architecture. None for partial states (no
    resnet keys), whose structure is ambiguous."""
    names = list(df_names)
    down_levels: dict[int, int] = {}
    down_attn: set[int] = set()
    up_levels: dict[int, int] = {}
    up_attn: set[int] = set()
    for n in names:
        m = re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.", n)
        if m:
            i, j = int(m.group(1)), int(m.group(2))
            down_levels[i] = max(down_levels.get(i, 0), j + 1)
        if re.match(r"down_blocks\.(\d+)\.attentions\.", n):
            down_attn.add(int(n.split(".")[1]))
        m = re.match(r"up_blocks\.(\d+)\.resnets\.(\d+)\.", n)
        if m:
            i, j = int(m.group(1)), int(m.group(2))
            up_levels[i] = max(up_levels.get(i, 0), j + 1)
        if re.match(r"up_blocks\.(\d+)\.attentions\.", n):
            up_attn.add(int(n.split(".")[1]))
    if not down_levels or not up_levels:
        return None
    n_levels = max(down_levels) + 1
    return UNetConfig(
        block_out_channels=tuple(320 for _ in range(n_levels)),  # unused by the map
        layers_per_block=max(down_levels.values()),
        down_block_types=tuple("CrossAttnDownBlock2D" if i in down_attn else "DownBlock2D"
                               for i in range(n_levels)),
        up_block_types=tuple("CrossAttnUpBlock2D" if i in up_attn else "UpBlock2D"
                             for i in range(max(up_levels) + 1)),
        addition_embed_type=("text_time" if any(n.startswith("add_embedding.") for n in names)
                             else None),
        projection_class_embeddings_input_dim=1,  # unused by the map
    )
