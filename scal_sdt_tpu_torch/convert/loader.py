"""Model loading: a diffusers directory or a single-file checkpoint -> flat
param dicts (port of ``scal_sdt_tpu/convert/loader.py``).

A diffusers directory holds ``unet/``, ``vae/``, ``text_encoder/`` and
``scheduler/``, each with a ``config.json`` and a weights file, and for SDXL
``text_encoder_2/`` (OpenCLIP bigG as ``CLIPTextModelWithProjection``); an
external VAE directory may replace the bundled one. An SD3 directory holds
``transformer/`` (the MMDiT, whose sincos ``pos_embed`` is synthesized when
the file lacks it) in place of ``unet/``, the 16-channel VAE, two projected
CLIP towers, an optional ``text_encoder_3/`` (T5) and a flow-matching
``scheduler/``.

A single ``.ckpt`` / ``.safetensors`` file is read in the layout its keys
name: SD3's sgm file (``model.diffusion_model.joint_blocks.*``, towers under
``text_encoders.*``), SDXL's sgm file (``conditioner.embedders.*``), or a
CompVis LDM file, SD1.x (``cond_stage_model.transformer.*``) or SD2.x
(OpenCLIP under ``cond_stage_model.model.*``), whose architecture comes from
an LDM YAML (``config.ldm_config``, the bundled v1-inference.yaml by
default). As in the JAX package, the YAML's ``parameterization`` is not
read: an SD2 v model needs ``schedule: {prediction_type: v}``. The VAE
may come from another file (``config.vae``).

Each component is validated against its shape template. The dicts hold CPU
tensors in the files' dtypes, keyed by the diffusers / transformers names;
the caller moves them to its device. A hub id (``org/name``) is read from
its snapshot in the local HF cache, found by the cache's own layout with no
network and no ``huggingface_hub``; only an id that was never cached is
downloaded, by ``huggingface_hub.snapshot_download`` where it is installed."""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Optional

import torch

from ..conf import Config, get_ldm_config
from ..diffusion.flow import FlowSchedule
from ..diffusion.schedule import NoiseSchedule
from ..models.clip import CLIPTextConfig, clip_param_shapes
from ..models.mmdit import POS_EMBED_KEY, MMDiTConfig, mmdit_param_shapes, sincos_pos_embed_2d
from ..models.t5 import T5Config, t5_param_shapes
from ..models.unet import UNetConfig, unet_param_shapes
from ..models.vae import VAEConfig, vae_param_shapes
from ..utils.state import load_state_dict, replace_prefix
from .sd_names import (convert_openclip_text_to_transformers, convert_unet_state_ldm_to_df,
                       convert_vae_state_ldm_to_df, normalize_df_vae_attention)

logger = logging.getLogger("loader")

Params = dict[str, torch.Tensor]


@dataclasses.dataclass
class LoadedModels:
    # the denoiser: a UNet, or for SD3 the MMDiT (unet_config None,
    # mmdit_config set)
    unet: Params
    unet_config: Optional[UNetConfig]
    vae: Params
    vae_config: VAEConfig
    clip: Params
    clip_config: CLIPTextConfig
    schedule: NoiseSchedule        # a FlowSchedule for SD3
    # SDXL's and SD3's second text tower (pooled projection); None for SD1.x/2.x
    clip2: Optional[Params] = None
    clip2_config: Optional[CLIPTextConfig] = None
    # SD3: the MMDiT's config and the optional T5 tower (text_encoder_3/)
    mmdit_config: Optional[MMDiTConfig] = None
    t5: Optional[Params] = None
    t5_config: Optional[T5Config] = None

    @property
    def is_sdxl(self) -> bool:
        return self.unet_config is not None and self.unet_config.addition_embed_type == "text_time"

    @property
    def is_sd3(self) -> bool:
        return self.mmdit_config is not None


def _validate(params: dict, shapes: dict, what: str):
    """Every templated key present at its shape; keys outside the template
    are dropped."""
    missing = [k for k in shapes if k not in params]
    if missing:
        raise ValueError(f"{what}: {len(missing)} missing params, e.g. {missing[:5]}")
    bad = [(k, tuple(params[k].shape), shapes[k]) for k in shapes
           if tuple(params[k].shape) != tuple(shapes[k])]
    if bad:
        raise ValueError(f"{what}: shape mismatches, e.g. {bad[:3]}")
    for k in [k for k in params if k not in shapes]:
        del params[k]


def _find_weights_file(d: Path) -> Path:
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "pytorch_model.safetensors", "diffusion_pytorch_model.bin",
                 "pytorch_model.bin", "model.ckpt"):
        if (d / name).exists():
            return d / name
    candidates = [p for p in d.iterdir() if p.suffix in (".safetensors", ".bin", ".ckpt")]
    if candidates:
        return candidates[0]
    raise FileNotFoundError(f"No weights file in {d}")


def _load_df_component_config(d: Path) -> dict:
    cfg = d / "config.json"
    return json.loads(cfg.read_text()) if cfg.exists() else {}


def _unet_config_from_df(cfg: dict) -> UNetConfig:
    if not cfg:
        return UNetConfig.sd15()
    # diffusers quirk: "attention_head_dim" historically holds the HEAD COUNT
    # (int for SD1.x, per-level list for SD2.x)
    heads = cfg.get("num_attention_heads") or cfg.get("attention_head_dim", 8)
    heads = tuple(heads) if isinstance(heads, (list, tuple)) else int(heads)
    t = cfg.get("transformer_layers_per_block", 1)
    return UNetConfig(
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=cfg.get("layers_per_block", 2),
        num_attention_heads=heads,
        use_linear_projection=bool(cfg.get("use_linear_projection", False)),
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        down_block_types=tuple(cfg.get("down_block_types", UNetConfig.sd15().down_block_types)),
        up_block_types=tuple(cfg.get("up_block_types", UNetConfig.sd15().up_block_types)),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        sample_size=cfg.get("sample_size", 64) or 64,
        transformer_layers_per_block=tuple(t) if isinstance(t, (list, tuple)) else int(t),
        addition_embed_type=cfg.get("addition_embed_type"),
        addition_time_embed_dim=int(cfg.get("addition_time_embed_dim") or 256),
        projection_class_embeddings_input_dim=cfg.get("projection_class_embeddings_input_dim"),
    )


def _vae_config_from_df(cfg: dict) -> VAEConfig:
    if not cfg:
        return VAEConfig.sd15()
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
        shift_factor=float(cfg.get("shift_factor") or 0.0),
        use_quant_conv=bool(cfg.get("use_quant_conv", True)),
        use_post_quant_conv=bool(cfg.get("use_post_quant_conv", True)),
    )


def _clip_config_from_df(cfg: dict, with_projection: bool = False) -> CLIPTextConfig:
    if not cfg:
        return CLIPTextConfig.vit_l()
    # only CLIPTextModelWithProjection components (SDXL's text_encoder_2)
    # carry a used projection head; a plain CLIPTextModel config may still
    # name a projection_dim that has no weights
    projection_dim = (int(cfg["projection_dim"])
                      if with_projection and cfg.get("projection_dim") else None)
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 768),
        intermediate_size=cfg.get("intermediate_size", 3072),
        num_hidden_layers=cfg.get("num_hidden_layers", 12),
        num_attention_heads=cfg.get("num_attention_heads", 12),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        projection_dim=projection_dim,
        eos_token_id=int(cfg.get("eos_token_id") or 49407),
    )


def _clip_config_from_state(clip: Params, hidden_act: str = "gelu") -> CLIPTextConfig:
    """The text tower's config from its transformers-layout state (single
    files carry no config.json); heads follow OpenCLIP's width // 64."""
    tok = clip["text_model.embeddings.token_embedding.weight"]
    layers = 0
    while f"text_model.encoder.layers.{layers}.layer_norm1.weight" in clip:
        layers += 1
    d = int(tok.shape[1])
    return CLIPTextConfig(
        vocab_size=int(tok.shape[0]), hidden_size=d,
        intermediate_size=int(clip["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0]),
        num_hidden_layers=layers, num_attention_heads=max(d // 64, 1),
        max_position_embeddings=int(
            clip["text_model.embeddings.position_embedding.weight"].shape[0]),
        hidden_act=hidden_act)


def _vae_dir(path: Path, vae_override: Optional[str]) -> Path:
    if not vae_override:
        return path / "vae"
    vae_dir = Path(vae_override)
    if not vae_dir.is_dir():
        raise FileNotFoundError(f"VAE override not found: {vae_override}")
    return vae_dir


def _load_sd3_diffusers_dir(path: Path, vae_override: Optional[str]) -> LoadedModels:
    """An SD3-family directory: transformer/ (the MMDiT), the 16-channel VAE,
    two projected CLIP towers, the optional text_encoder_3/ (T5) and a
    FlowSchedule from scheduler/."""
    tr_dir = path / "transformer"
    mmdit_config = MMDiTConfig.from_json(_load_df_component_config(tr_dir))
    mmdit = load_state_dict(_find_weights_file(tr_dir))
    if POS_EMBED_KEY not in mmdit:
        # a non-persistent buffer in some exports: the fixed sincos table
        mmdit[POS_EMBED_KEY] = sincos_pos_embed_2d(mmdit_config.inner_dim,
                                                   mmdit_config.pos_embed_max_size)

    vae_dir = _vae_dir(path, vae_override)
    vae_config = _vae_config_from_df(_load_df_component_config(vae_dir))
    vae = normalize_df_vae_attention(load_state_dict(_find_weights_file(vae_dir)))

    clips = []
    for sub in ("text_encoder", "text_encoder_2"):
        d = path / sub
        cfg = _clip_config_from_df(_load_df_component_config(d), with_projection=True)
        state = load_state_dict(_find_weights_file(d))
        state.pop("text_model.embeddings.position_ids", None)
        if cfg.projection_dim is None:
            raise ValueError(f"SD3 {sub} must carry a text_projection head")
        clips.append((state, cfg))

    t5 = t5_config = None
    te3_dir = path / "text_encoder_3"
    if te3_dir.is_dir():
        t5_config = T5Config.from_json(_load_df_component_config(te3_dir))
        t5 = load_state_dict(_find_weights_file(te3_dir))
        _validate(t5, t5_param_shapes(t5_config), "text_encoder_3")

    sched_file = path / "scheduler" / "scheduler_config.json"
    schedule = (FlowSchedule.from_diffusers_scheduler_config(json.loads(sched_file.read_text()))
                if sched_file.exists() else FlowSchedule())

    _validate(mmdit, mmdit_param_shapes(mmdit_config), "transformer")
    _validate(vae, vae_param_shapes(vae_config), "vae")
    _validate(clips[0][0], clip_param_shapes(clips[0][1]), "text_encoder")
    _validate(clips[1][0], clip_param_shapes(clips[1][1]), "text_encoder_2")
    return LoadedModels(mmdit, None, vae, vae_config, clips[0][0], clips[0][1], schedule,
                        clip2=clips[1][0], clip2_config=clips[1][1],
                        mmdit_config=mmdit_config, t5=t5, t5_config=t5_config)


def load_diffusers_dir(path: Path, vae_override: Optional[str] = None) -> LoadedModels:
    path = Path(path)
    if (path / "transformer").is_dir() and not (path / "unet").is_dir():
        return _load_sd3_diffusers_dir(path, vae_override)

    unet_dir = path / "unet"
    unet_config = _unet_config_from_df(_load_df_component_config(unet_dir))
    unet = load_state_dict(_find_weights_file(unet_dir))

    vae_dir = _vae_dir(path, vae_override)
    vae_config = _vae_config_from_df(_load_df_component_config(vae_dir))
    vae = normalize_df_vae_attention(load_state_dict(_find_weights_file(vae_dir)))

    te_dir = path / "text_encoder"
    clip_config = _clip_config_from_df(_load_df_component_config(te_dir))
    clip = load_state_dict(_find_weights_file(te_dir))
    clip.pop("text_model.embeddings.position_ids", None)

    clip2 = clip2_config = None
    te2_dir = path / "text_encoder_2"
    if te2_dir.is_dir():
        clip2_config = _clip_config_from_df(_load_df_component_config(te2_dir),
                                            with_projection=True)
        clip2 = load_state_dict(_find_weights_file(te2_dir))
        clip2.pop("text_model.embeddings.position_ids", None)

    sched_file = path / "scheduler" / "scheduler_config.json"
    schedule = (NoiseSchedule.from_diffusers_scheduler_config(json.loads(sched_file.read_text()))
                if sched_file.exists() else NoiseSchedule())

    _validate(unet, unet_param_shapes(unet_config), "unet")
    _validate(vae, vae_param_shapes(vae_config), "vae")
    _validate(clip, clip_param_shapes(clip_config), "text_encoder")
    if clip2 is not None:
        _validate(clip2, clip_param_shapes(clip2_config), "text_encoder_2")
    if unet_config.addition_embed_type == "text_time":
        if clip2 is None:
            raise ValueError("SDXL UNet (addition_embed_type=text_time) requires a "
                             "text_encoder_2/ directory with the pooled-projection tower")
        if clip2_config.projection_dim is None:
            raise ValueError("text_encoder_2 has no projection head (projection_dim missing "
                             "from its config.json / no text_projection.weight): the SDXL "
                             "text_time conditioning needs the pooled projected embedding")
    return LoadedModels(unet, unet_config, vae, vae_config, clip, clip_config, schedule,
                        clip2=clip2, clip2_config=clip2_config)


def _vae_config_from_ldm_state(vae_ldm: Params) -> VAEConfig:
    """The VAE's architecture from an LDM-layout first-stage state. SD3's
    16-channel VAE is told by its latent width and its missing quant
    convs."""
    ch = []
    while f"encoder.down.{len(ch)}.block.0.conv1.weight" in vae_ldm:
        ch.append(int(vae_ldm[f"encoder.down.{len(ch)}.block.0.conv1.weight"].shape[0]))
    layers = 0
    while f"encoder.down.0.block.{layers}.conv1.weight" in vae_ldm:
        layers += 1
    z = int(vae_ldm["encoder.conv_out.weight"].shape[0]) // 2
    sd3like = z == 16
    return VAEConfig(
        in_channels=int(vae_ldm["encoder.conv_in.weight"].shape[1]),
        out_channels=int(vae_ldm["decoder.conv_out.weight"].shape[0]),
        latent_channels=z, block_out_channels=tuple(ch), layers_per_block=layers,
        norm_num_groups=next(g for g in (32, 8, 4, 1) if ch[0] % g == 0),
        scaling_factor=1.5305 if sd3like else 0.18215,
        shift_factor=0.0609 if sd3like else 0.0,
        use_quant_conv="quant_conv.weight" in vae_ldm,
        use_post_quant_conv="post_quant_conv.weight" in vae_ldm,
    )


def _t5_config_from_state(t5: Params) -> T5Config:
    """T5Config from a transformers-layout encoder state."""
    shared = t5["shared.weight"]
    layers = 0
    while f"encoder.block.{layers}.layer.0.SelfAttention.q.weight" in t5:
        layers += 1
    rel = t5["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    heads = int(rel.shape[1])
    inner = int(t5["encoder.block.0.layer.0.SelfAttention.q.weight"].shape[0])
    gated = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in t5
    ff_key = f"encoder.block.0.layer.1.DenseReluDense.{'wi_0' if gated else 'wi'}.weight"
    return T5Config(
        vocab_size=int(shared.shape[0]), d_model=int(shared.shape[1]),
        d_kv=inner // heads, d_ff=int(t5[ff_key].shape[0]),
        num_layers=layers, num_heads=heads,
        relative_attention_num_buckets=int(rel.shape[0]),
        feed_forward_proj="gated-gelu" if gated else "relu")


def _vae_ldm_state(state: Params, vae_path: Optional[str]) -> Params:
    """The LDM-layout VAE of the checkpoint, or of ``vae_path`` (a first
    stage alone, or a checkpoint holding one under ``first_stage_model.``)."""
    if vae_path is None:
        return replace_prefix(state, "first_stage_model.")
    vae_state = load_state_dict(Path(vae_path))
    return replace_prefix(vae_state, "first_stage_model.") or vae_state


def _load_sd3_single_file(state: Params, vae_path: Optional[str] = None, head_dim: int = 64,
                          pos_embed_max_size: Optional[int] = None) -> LoadedModels:
    """An SD3 / SD3.5 single file (the WebUI / ComfyUI distribution): the
    MMDiT under ``model.diffusion_model.*`` in sgm naming, the towers under
    ``text_encoders.{clip_l,clip_g,t5xxl}.transformer.*`` (transformers
    layout), the 16-channel VAE under ``first_stage_model.*``."""
    from .mmdit_names import convert_mmdit_state_sgm_to_df, mmdit_config_from_sgm_state

    sgm = replace_prefix(state, "model.diffusion_model.")
    mmdit_config = mmdit_config_from_sgm_state(sgm, head_dim=head_dim,
                                               pos_embed_max_size=pos_embed_max_size)
    mmdit = convert_mmdit_state_sgm_to_df(sgm)
    if POS_EMBED_KEY not in mmdit:
        # the fixed sincos buffer, non-persistent in some exports
        mmdit[POS_EMBED_KEY] = sincos_pos_embed_2d(mmdit_config.inner_dim,
                                                   mmdit_config.pos_embed_max_size)

    vae_ldm = _vae_ldm_state(state, vae_path)
    if not vae_ldm:
        raise ValueError("SD3 single-file checkpoint has no bundled VAE (first_stage_model.*); "
                         "pass one via --vae / config.vae")
    vae_config = _vae_config_from_ldm_state(vae_ldm)
    vae = convert_vae_state_ldm_to_df(vae_ldm, vae_config)

    clips = []
    for tower, act in (("clip_l", "quick_gelu"), ("clip_g", "gelu")):
        st = replace_prefix(state, f"text_encoders.{tower}.transformer.")
        if not st:
            raise ValueError(
                f"SD3 single-file checkpoint has no bundled {tower} tower (text_encoders.*): "
                "use the incl-clips distribution or the diffusers directory layout")
        st.pop("text_model.embeddings.position_ids", None)
        proj = st.get("text_projection.weight")
        if proj is None:
            raise ValueError(f"SD3 {tower} tower is missing text_projection (the pooled "
                             "conditioning needs it)")
        cfg = dataclasses.replace(_clip_config_from_state(st, hidden_act=act),
                                  projection_dim=int(proj.shape[0]))
        clips.append((st, cfg))

    t5 = t5_config = None
    t5_state = replace_prefix(state, "text_encoders.t5xxl.transformer.")
    if t5_state:
        t5_config = _t5_config_from_state(t5_state)
        _validate(t5_state, t5_param_shapes(t5_config), "t5xxl")
        t5 = t5_state

    _validate(mmdit, mmdit_param_shapes(mmdit_config), "transformer")
    _validate(vae, vae_param_shapes(vae_config), "vae")
    _validate(clips[0][0], clip_param_shapes(clips[0][1]), "clip_l")
    _validate(clips[1][0], clip_param_shapes(clips[1][1]), "clip_g")
    return LoadedModels(mmdit, None, vae, vae_config, clips[0][0], clips[0][1], FlowSchedule(),
                        clip2=clips[1][0], clip2_config=clips[1][1],
                        mmdit_config=mmdit_config, t5=t5, t5_config=t5_config)


def _load_sdxl_single_file(state: Params, ldm_config: Optional[Config] = None,
                           vae_path: Optional[str] = None) -> LoadedModels:
    """A WebUI-style SDXL single file (sgm namespace): the UNet under
    ``model.diffusion_model.*`` (SDXL-base unless an sgm YAML says
    otherwise), CLIP-L under ``conditioner.embedders.0.transformer.*``
    (transformers layout) and OpenCLIP bigG with its text_projection under
    ``conditioner.embedders.1.model.*``."""
    has_sgm_yaml = ldm_config is not None and "network_config" in ldm_config.model.params
    unet_config = UNetConfig.from_sgm_config(ldm_config) if has_sgm_yaml else UNetConfig.sdxl()
    unet = convert_unet_state_ldm_to_df(replace_prefix(state, "model.diffusion_model."),
                                        unet_config)

    vae_config = dataclasses.replace(
        VAEConfig.from_ldm_config(ldm_config) if has_sgm_yaml else VAEConfig.sd15(),
        scaling_factor=0.13025)
    vae = convert_vae_state_ldm_to_df(_vae_ldm_state(state, vae_path), vae_config)

    clip = replace_prefix(state, "conditioner.embedders.0.transformer.")
    clip.pop("text_model.embeddings.position_ids", None)
    # real SDXL ships the standard CLIP-L here; infer (quick_gelu) only when
    # the tower deviates from ViT-L's depth
    clip_config = CLIPTextConfig.vit_l()
    if (f"text_model.encoder.layers.{clip_config.num_hidden_layers - 1}.layer_norm1.weight"
            not in clip):
        clip_config = _clip_config_from_state(clip, hidden_act="quick_gelu")

    clip2 = convert_openclip_text_to_transformers(
        replace_prefix(state, "conditioner.embedders.1.model."), keep_projection=True)
    proj = clip2.get("text_projection.weight")
    if proj is None:
        raise ValueError("SDXL single-file checkpoint is missing the tower-2 text_projection")
    clip2_config = dataclasses.replace(_clip_config_from_state(clip2),
                                       projection_dim=int(proj.shape[0]))

    _validate(unet, unet_param_shapes(unet_config), "unet")
    _validate(vae, vae_param_shapes(vae_config), "vae")
    _validate(clip, clip_param_shapes(clip_config), "text_encoder")
    _validate(clip2, clip_param_shapes(clip2_config), "text_encoder_2")
    # SDXL-base trains the SD default schedule
    return LoadedModels(unet, unet_config, vae, vae_config, clip, clip_config, NoiseSchedule(),
                        clip2=clip2, clip2_config=clip2_config)


def load_ldm_checkpoint(path: Path, ldm_config: Optional[Config] = None,
                        vae_path: Optional[str] = None, mmdit_head_dim: int = 64,
                        mmdit_pos_embed_max_size: Optional[int] = None) -> LoadedModels:
    """A single-file checkpoint, dispatched on its keys: SD3 (``joint_blocks``),
    SDXL (``conditioner.embedders.1.model``), else a CompVis LDM file of
    SD1.x or, with OpenCLIP under ``cond_stage_model.model``, SD2.x, shaped
    by ``ldm_config`` (the bundled v1 YAML when None)."""
    state = load_state_dict(Path(path))
    if any(k.startswith("model.diffusion_model.joint_blocks.") for k in state):
        return _load_sd3_single_file(state, vae_path, head_dim=mmdit_head_dim,
                                     pos_embed_max_size=mmdit_pos_embed_max_size)
    if any(k.startswith("conditioner.embedders.1.model.") for k in state):
        return _load_sdxl_single_file(state, ldm_config, vae_path)
    ldm_config = ldm_config if ldm_config is not None else get_ldm_config(None)

    unet_config = UNetConfig.from_ldm_config(ldm_config)
    unet = convert_unet_state_ldm_to_df(replace_prefix(state, "model.diffusion_model."),
                                        unet_config)
    vae_config = VAEConfig.from_ldm_config(ldm_config)
    vae = convert_vae_state_ldm_to_df(_vae_ldm_state(state, vae_path), vae_config)

    openclip = replace_prefix(state, "cond_stage_model.model.")
    if openclip:
        # SD2.x: OpenCLIP ViT-H (resblocks, fused in_proj)
        clip = convert_openclip_text_to_transformers(openclip)
        clip_config = _clip_config_from_state(clip)
    else:
        clip = replace_prefix(state, "cond_stage_model.transformer.")
        clip.pop("text_model.embeddings.position_ids", None)
        # SD1.x bundles ViT-L (quick_gelu): inferring the shapes gives
        # CLIPTextConfig.vit_l() for real files and takes deviating towers
        clip_config = (_clip_config_from_state(clip, hidden_act="quick_gelu")
                       if clip else CLIPTextConfig.vit_l())

    _validate(unet, unet_param_shapes(unet_config), "unet")
    _validate(vae, vae_param_shapes(vae_config), "vae")
    _validate(clip, clip_param_shapes(clip_config), "text_encoder")
    return LoadedModels(unet, unet_config, vae, vae_config, clip, clip_config,
                        NoiseSchedule.from_ldm_config(ldm_config))


def hub_cache_dir() -> Path:
    """The HF hub cache, as ``huggingface_hub`` finds it: ``HF_HUB_CACHE``
    (or the older ``HUGGINGFACE_HUB_CACHE``), else ``HF_HOME/hub``, else
    ``$XDG_CACHE_HOME/huggingface/hub`` (``~/.cache/huggingface/hub``)."""
    for var in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE"):
        if os.environ.get(var):
            return Path(os.path.expandvars(os.path.expanduser(os.environ[var])))
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or "~/.cache", "huggingface")
    return Path(os.path.expandvars(os.path.expanduser(home))) / "hub"


def cached_snapshot(name: str) -> Optional[Path]:
    """The local snapshot of hub id ``org/name`` at its ``main`` ref:
    ``<cache>/models--{org}--{name}/refs/main`` names the revision,
    ``snapshots/<rev>`` holds it. None when it is not cached."""
    parts = name.split("/")
    if len(parts) != 2 or not all(parts):
        return None
    repo = hub_cache_dir() / f"models--{parts[0]}--{parts[1]}"
    try:
        rev = (repo / "refs" / "main").read_text().strip()
    except OSError:
        return None
    snapshot = repo / "snapshots" / rev
    return snapshot if rev and snapshot.is_dir() else None


def _resolve_hub_id(name: str) -> Path:
    """HF hub id -> local diffusers directory (the reference passes hub ids
    to ``from_pretrained``). Resolution order:
    1. the local HF cache (``cached_snapshot``): works offline when the
       model was ever downloaded before;
    2. a download by ``huggingface_hub.snapshot_download`` where that
       package is installed and the network is there.
    Raises an actionable error otherwise."""
    if "/" not in name or name.startswith((".", "/")):
        raise FileNotFoundError(
            f"Model '{name}' not found locally and is not a hub id "
            "(expected 'org/name')")
    snapshot = cached_snapshot(name)
    if snapshot is not None:
        logger.info(f"hub id {name}: the local HF cache's {snapshot}")
        return snapshot
    try:
        from huggingface_hub import snapshot_download

        return Path(snapshot_download(name))
    except Exception as e:  # noqa: BLE001 - every failure gets the one actionable error
        raise FileNotFoundError(
            f"Model '{name}' is neither a local path, nor in the local HF "
            f"cache, nor downloadable ({type(e).__name__}: {e}) — pass a "
            "local diffusers directory or LDM file instead") from e


def load_components(config: Config) -> LoadedModels:
    """Load ``config.model``: a single-file checkpoint (with
    ``config.ldm_config``, ``config.vae`` as another VAE file, and for SD3
    ``mmdit_head_dim`` / ``mmdit_pos_embed_max_size``) or a diffusers
    directory (``config.vae`` an external VAE directory) or a hub id's
    snapshot (``_resolve_hub_id``). An optional
    ``schedule:`` config section overrides fields of the loaded noise
    schedule (e.g. ``prediction_type: v`` with
    ``rescale_zero_terminal_snr: true``)."""
    name = config.model
    if name is None:
        raise ValueError("config.model is not set")
    p = Path(str(name))
    if p.is_file():
        pe = config.get("mmdit_pos_embed_max_size")
        models = load_ldm_checkpoint(p, get_ldm_config(config.get("ldm_config")),
                                     config.get("vae"),
                                     mmdit_head_dim=int(config.get("mmdit_head_dim") or 64),
                                     mmdit_pos_embed_max_size=int(pe) if pe else None)
    elif p.is_dir():
        models = load_diffusers_dir(p, config.get("vae"))
    else:
        models = load_diffusers_dir(_resolve_hub_id(str(name)), config.get("vae"))

    overrides = dict(config.get("schedule") or {})
    if overrides:
        models = dataclasses.replace(
            models, schedule=dataclasses.replace(models.schedule, **overrides))
    return models
