"""Bidirectional tensor-name maps between the CompVis LDM and diffusers
layouts, and between OpenCLIP and transformers text towers (port of
``scal_sdt_tpu/convert/sd_names.py``).

For SD1.x/2.x and SDXL the two UNet and VAE layouts differ only by a
deterministic renaming (plus a 2-D <-> 4-D reshape of the VAE mid-block
attention projections, which LDM stores as 1x1 convs), so both directions
derive from one name map built from the model configs. LDM checkpoints prefix
these names with ``model.diffusion_model.`` (UNet), ``first_stage_model.``
(VAE) and ``cond_stage_model.transformer.`` (CLIP) or, for SD2.x,
``cond_stage_model.model.`` (OpenCLIP); the callers (loader, checkpoint
tools) handle the prefixes. The UNet's prefix pairs also resolve kohya LoRA
files written against LDM names. Tensors pass through unchanged (CPU torch
tensors, any dtype) except where a layout reshapes, splits or fuses them.
"""

from __future__ import annotations

import re
from typing import Iterable

import torch

from ..models.unet import UNetConfig, unet_param_shapes
from ..models.vae import VAEConfig, vae_param_shapes

_RESNET_RENAMES = [
    ("norm1", "in_layers.0"),
    ("conv1", "in_layers.2"),
    ("norm2", "out_layers.0"),
    ("conv2", "out_layers.3"),
    ("time_emb_proj", "emb_layers.1"),
    ("conv_shortcut", "skip_connection"),
]

# VAE attention leaf names: modern diffusers -> LDM
_VAE_ATTN_RENAMES = [
    ("group_norm", "norm"),
    ("to_q", "q"),
    ("to_k", "k"),
    ("to_v", "v"),
    ("to_out.0", "proj_out"),
]

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


def vae_prefix_map(config: VAEConfig) -> list[tuple[str, str]]:
    """(diffusers_prefix, ldm_prefix) pairs of the VAE's modules."""
    pairs = [
        ("encoder.conv_in.", "encoder.conv_in."),
        ("encoder.conv_norm_out.", "encoder.norm_out."),
        ("encoder.conv_out.", "encoder.conv_out."),
        ("decoder.conv_in.", "decoder.conv_in."),
        ("decoder.conv_norm_out.", "decoder.norm_out."),
        ("decoder.conv_out.", "decoder.conv_out."),
        ("quant_conv.", "quant_conv."),
        ("post_quant_conv.", "post_quant_conv."),
    ]
    n = len(config.block_out_channels)
    for i in range(n):
        for j in range(config.layers_per_block):
            pairs.append((f"encoder.down_blocks.{i}.resnets.{j}.", f"encoder.down.{i}.block.{j}."))
        if i != n - 1:
            pairs.append((f"encoder.down_blocks.{i}.downsamplers.0.",
                          f"encoder.down.{i}.downsample."))
        for j in range(config.layers_per_block + 1):
            pairs.append((f"decoder.up_blocks.{i}.resnets.{j}.",
                          f"decoder.up.{n - 1 - i}.block.{j}."))
        if i != n - 1:
            pairs.append((f"decoder.up_blocks.{i}.upsamplers.0.",
                          f"decoder.up.{n - 1 - i}.upsample."))
    for enc_dec in ("encoder", "decoder"):
        pairs.append((f"{enc_dec}.mid_block.resnets.0.", f"{enc_dec}.mid.block_1."))
        pairs.append((f"{enc_dec}.mid_block.resnets.1.", f"{enc_dec}.mid.block_2."))
        pairs.append((f"{enc_dec}.mid_block.attentions.0.", f"{enc_dec}.mid.attn_1."))
    return pairs


def _build_name_map(prefix_pairs: list[tuple[str, str]], df_names: Iterable[str],
                    unet_resnets: bool) -> dict[str, str]:
    """diffusers name -> LDM name for every given key. The inner renames are
    gated on the diffusers path, so a transformer block's ``norm1`` is never
    rewritten (renames apply inside ``.resnets.`` and the VAE's
    ``.attentions.`` only)."""
    out = {}
    for name in df_names:
        new = name
        for df_p, ldm_p in prefix_pairs:
            if new.startswith(df_p):
                new = ldm_p + new[len(df_p):]
                break
        if ".resnets." in name:
            if unet_resnets:
                new = apply_renames(new, _RESNET_RENAMES)
            else:
                new = new.replace("conv_shortcut", "nin_shortcut")
        if not unet_resnets and ".attentions." in name:
            new = apply_renames(new, _VAE_ATTN_RENAMES)
        out[name] = new
    return out


def unet_name_map(config: UNetConfig, df_names: Iterable[str]) -> dict[str, str]:
    return _build_name_map(unet_prefix_map(config), df_names, unet_resnets=True)


def vae_name_map(config: VAEConfig, df_names: Iterable[str]) -> dict[str, str]:
    return _build_name_map(vae_prefix_map(config), df_names, unet_resnets=False)


def _unconsumed(what: str, config, unconsumed: list[str], hint: str) -> ValueError:
    preview = ", ".join(sorted(unconsumed)[:8])
    return ValueError(f"LDM {what} state has {len(unconsumed)} keys not consumed by the "
                      f"{type(config).__name__} layout (first: {preview}){hint}")


def convert_unet_state_df_to_ldm(state: dict[str, torch.Tensor],
                                 config: UNetConfig = UNetConfig.sd15()) -> dict[str, torch.Tensor]:
    """Diffusers-layout UNet state -> LDM names."""
    name_map = unet_name_map(config, state.keys())
    return {name_map[k]: v for k, v in state.items()}


def split_fused_qkv(state: dict[str, torch.Tensor],
                    num_head_channels: int = 8) -> dict[str, torch.Tensor]:
    """Legacy CompVis AttentionBlock tensors of an LDM UNet state, normalized:
    a fused ``<block>.qkv.{weight,bias}`` (1-D conv, q/k/v rows interleaved
    per head) is split per head into ``q``, ``k``, ``v`` linears, and a 1-D
    conv ``proj_out`` weight becomes linear."""
    out = {}
    for k, v in state.items():
        if k.endswith(("qkv.weight", "qkv.bias")):
            three_c = v.shape[0]
            channels = three_c // 3
            num_heads = three_c // num_head_channels // 3
            per_head = channels // num_heads
            interleaved = v.reshape((num_heads, 3 * per_head) + tuple(v.shape[1:]))
            target = (-1, channels) if v.dim() == 3 else (-1,)
            leaf = k.rsplit(".", 1)[1]
            base = k[: -len(f"qkv.{leaf}")]
            for i, name in enumerate("qkv"):
                out[f"{base}{name}.{leaf}"] = (
                    interleaved[:, i * per_head:(i + 1) * per_head].reshape(target))
        elif k.endswith("proj_out.weight") and v.dim() == 3:
            out[k] = v[:, :, 0]
        else:
            out[k] = v
    return out


def convert_unet_state_ldm_to_df(state: dict[str, torch.Tensor],
                                 config: UNetConfig = UNetConfig.sd15(),
                                 strict: bool = True) -> dict[str, torch.Tensor]:
    """LDM-layout UNet state (without ``model.diffusion_model.``) ->
    diffusers names. ``strict`` raises on keys the map does not consume (a
    checkpoint whose architecture does not match ``config``) rather than
    load an incomplete model."""
    state = split_fused_qkv(state)
    name_map = unet_name_map(config, unet_param_shapes(config).keys())
    inverse = {v: k for k, v in name_map.items()}
    out, unconsumed = {}, []
    for k, v in state.items():
        if k in inverse:
            out[inverse[k]] = v
        else:
            unconsumed.append(k)
    if strict and unconsumed:
        raise _unconsumed("UNet", config, unconsumed,
                          ". The checkpoint architecture does not match; refusing to load "
                          "it incomplete.")
    return out


def convert_vae_state_df_to_ldm(state: dict[str, torch.Tensor],
                                config: VAEConfig = VAEConfig.sd15()) -> dict[str, torch.Tensor]:
    """Diffusers-layout VAE -> LDM names, with the mid-block attention's
    linear weights as the 1x1 convs LDM stores."""
    name_map = vae_name_map(config, state.keys())
    out = {}
    for k, v in state.items():
        new = name_map[k]
        if "attn_1" in new and new.endswith(".weight") and v.dim() == 2:
            v = v.reshape(*v.shape, 1, 1)
        out[new] = v
    return out


def convert_vae_state_ldm_to_df(state: dict[str, torch.Tensor],
                                config: VAEConfig = VAEConfig.sd15(),
                                strict: bool = True) -> dict[str, torch.Tensor]:
    """LDM-layout VAE (without ``first_stage_model.``) -> diffusers names,
    the 1x1-conv attention weights squeezed to linear. A standalone first
    stage's LPIPS / discriminator (``loss.``) and ``model_ema.`` tensors are
    skipped."""
    name_map = vae_name_map(config, vae_param_shapes(config).keys())
    inverse = {v: k for k, v in name_map.items()}
    out, unconsumed = {}, []
    for k, v in state.items():
        if k not in inverse:
            if not k.startswith(("loss.", "model_ema.")):
                unconsumed.append(k)
            continue
        new = inverse[k]
        if "attentions" in new and new.endswith(".weight") and v.dim() == 4:
            v = v.reshape(v.shape[0], v.shape[1])
        out[new] = v
    if strict and unconsumed:
        raise _unconsumed("VAE", config, unconsumed, "; refusing to load it incomplete.")
    return out


_OPENCLIP_LEAF_RENAMES = [
    ("ln_1.", "layer_norm1."),
    ("ln_2.", "layer_norm2."),
    ("mlp.c_fc.", "mlp.fc1."),
    ("mlp.c_proj.", "mlp.fc2."),
    ("attn.out_proj.", "self_attn.out_proj."),
]

_OPENCLIP_TOP = {
    "token_embedding.weight": "text_model.embeddings.token_embedding.weight",
    "positional_embedding": "text_model.embeddings.position_embedding.weight",
    "ln_final.weight": "text_model.final_layer_norm.weight",
    "ln_final.bias": "text_model.final_layer_norm.bias",
}


def convert_transformers_text_to_openclip(state: dict[str, torch.Tensor]
                                          ) -> dict[str, torch.Tensor]:
    """transformers CLIP text tower -> OpenCLIP (``resblocks``, fused
    ``attn.in_proj``, ``text_projection`` stored as the ``x @ P`` matrix):
    the inverse of ``convert_openclip_text_to_transformers`` without its
    24-block drop. Publishes SD2.x's tower (``cond_stage_model.model.``) and
    SDXL's tower 2 (``conditioner.embedders.1.model.``)."""
    layers: dict[int, dict[str, torch.Tensor]] = {}
    for k, v in state.items():
        m = re.match(r"text_model\.encoder\.layers\.(\d+)\.(.+)$", k)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = v
    out: dict[str, torch.Tensor] = {}
    for i, leaves in layers.items():
        pre = f"transformer.resblocks.{i}."
        for kind in ("weight", "bias"):
            out[pre + f"attn.in_proj_{kind}"] = torch.cat(
                [leaves[f"self_attn.{p}_proj.{kind}"] for p in "qkv"], dim=0)
        for leaf, v in leaves.items():
            if leaf.startswith(("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")):
                continue
            for openclip, transformers in _OPENCLIP_LEAF_RENAMES:
                if leaf.startswith(transformers):
                    leaf = openclip + leaf.removeprefix(transformers)
                    break
            out[pre + leaf] = v
    for openclip, transformers in _OPENCLIP_TOP.items():
        if transformers in state:
            out[openclip] = state[transformers]
    if "text_projection.weight" in state:
        out["text_projection"] = state["text_projection.weight"].t().contiguous()
    return out


def convert_openclip_text_to_transformers(state: dict[str, torch.Tensor],
                                          keep_projection: bool = False
                                          ) -> dict[str, torch.Tensor]:
    """OpenCLIP text tower (SD2.x's ``cond_stage_model.model.``, SDXL's
    ``conditioner.embedders.1.model.``, prefix stripped) -> transformers
    ``CLIPTextModel`` layout: ``resblocks.N`` -> ``encoder.layers.N``, the
    fused ``attn.in_proj`` split row-wise into thirds (q, k, v stacked, not
    interleaved per head). With exactly 24 resblocks (ViT-H) the last is
    dropped: SD2 conditions on the penultimate layer and diffusers ships the
    equivalent 23-layer encoder. ``keep_projection`` keeps SDXL tower 2's
    ``text_projection`` (stored for ``x @ P``) as a Linear weight; SD2's is
    dropped, as is ``logit_scale``."""
    n_blocks = 0
    for k in state:
        m = re.match(r"transformer\.resblocks\.(\d+)\.", k)
        if m:
            n_blocks = max(n_blocks, int(m.group(1)) + 1)
    if n_blocks == 0:
        raise ValueError("No transformer.resblocks.* keys: not an OpenCLIP text tower")
    keep = n_blocks - 1 if n_blocks == 24 else n_blocks

    out: dict[str, torch.Tensor] = {}
    consumed = set()
    for k, v in state.items():
        m = re.match(r"transformer\.resblocks\.(\d+)\.(.+)$", k)
        if not m:
            continue
        i, leaf = int(m.group(1)), m.group(2)
        consumed.add(k)
        if i >= keep:
            continue
        pre = f"text_model.encoder.layers.{i}."
        if leaf.startswith("attn.in_proj_"):
            kind = leaf.removeprefix("attn.in_proj_")
            d = v.shape[0] // 3
            for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
                out[f"{pre}self_attn.{name}.{kind}"] = v[j * d:(j + 1) * d]
            continue
        for openclip, transformers in _OPENCLIP_LEAF_RENAMES:
            if leaf.startswith(openclip):
                leaf = transformers + leaf.removeprefix(openclip)
                break
        out[pre + leaf] = v

    for openclip, transformers in _OPENCLIP_TOP.items():
        if openclip in state:
            out[transformers] = state[openclip]
            consumed.add(openclip)
    if keep_projection and "text_projection" in state:
        out["text_projection.weight"] = state["text_projection"].t().contiguous()
    consumed.update(k for k in ("text_projection", "logit_scale") if k in state)

    leftover = [k for k in state if k not in consumed]
    if leftover:
        raise ValueError(f"OpenCLIP conversion left {len(leftover)} unconsumed keys, "
                         f"e.g. {leftover[:5]}")
    return out
