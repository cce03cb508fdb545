"""Model loading: a diffusers directory -> flat param dicts (port of
``scal_sdt_tpu/convert/loader.py``, the SD1.x/2.x, SDXL and SD3 directory
layouts).

A diffusers directory holds ``unet/``, ``vae/``, ``text_encoder/`` and
``scheduler/``, each with a ``config.json`` and a weights file, and for SDXL
``text_encoder_2/`` (OpenCLIP bigG as ``CLIPTextModelWithProjection``); an
external VAE directory may replace the bundled one. An SD3 directory holds
``transformer/`` (the MMDiT, whose sincos ``pos_embed`` is synthesized when
the file lacks it) in place of ``unet/``, the 16-channel VAE, two projected
CLIP towers, an optional ``text_encoder_3/`` (T5) and a flow-matching
``scheduler/``. Each component is validated against its shape template. The
dicts hold CPU tensors in the files' dtypes, keyed by the diffusers /
transformers names; the caller moves them to its device.

Not ported yet, and refused with an error: single-file checkpoints (LDM,
SDXL's sgm layout and single-file SD3, ROADMAP 1.18) and hub ids.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Optional

import torch

from ..conf import Config
from ..diffusion.flow import FlowSchedule
from ..diffusion.schedule import NoiseSchedule
from ..models.clip import CLIPTextConfig, clip_param_shapes
from ..models.mmdit import POS_EMBED_KEY, MMDiTConfig, mmdit_param_shapes, sincos_pos_embed_2d
from ..models.t5 import T5Config, t5_param_shapes
from ..models.unet import UNetConfig, unet_param_shapes
from ..models.vae import VAEConfig, vae_param_shapes
from ..utils.state import load_state_dict
from .sd_names import normalize_df_vae_attention

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


def load_components(config: Config) -> LoadedModels:
    """Load ``config.model`` (a diffusers directory), with ``config.vae`` as
    an external VAE directory. An optional ``schedule:`` config section
    overrides fields of the loaded noise schedule (e.g. ``prediction_type:
    v`` with ``rescale_zero_terminal_snr: true``)."""
    name = config.model
    if name is None:
        raise ValueError("config.model is not set")
    p = Path(str(name))
    if p.is_file():
        raise NotImplementedError(
            f"{p}: single-file (LDM / sgm) checkpoints are not ported yet (ROADMAP 1.18); "
            "pass a diffusers directory")
    if not p.is_dir():
        raise NotImplementedError(
            f"model {name!r} is not a local directory: hub ids are not ported yet")
    models = load_diffusers_dir(p, config.get("vae"))

    overrides = dict(config.get("schedule") or {})
    if overrides:
        models = dataclasses.replace(
            models, schedule=dataclasses.replace(models.schedule, **overrides))
    return models
