"""Checkpoint toolchain (port of ``scal_sdt_tpu/cli/ckpt_tool.py``):

    python -m scal_sdt_tpu_torch.cli.ckpt_tool {prune,lora,graft,embedding} ...

* ``prune``: a training checkpoint -> a WebUI-loadable single file, with a
  dtype per component, the EMA weights on request, and the VAE (from an LDM
  file or a diffusers directory) and the text encoder(s) optionally
  included: SD1.x's ``cond_stage_model.transformer.*``, SD2.x's OpenCLIP
  ``cond_stage_model.model.*``, SDXL's ``conditioner.embedders.{0,1}``; SD3
  in the diffusers ``transformer/`` layout or as an sgm single file.
* ``lora``: LoRA factors -> kohya / AddNet ``lora_unet_*`` / ``lora_te_*``
  (SDXL: ``lora_te1_`` / ``lora_te2_``), the alpha read back from the run's
  ``config.yaml`` when the checkpoint stores none.
* ``graft``: overwrite submodule subtrees of a base model from other models
  by a layer spec.
* ``embedding``: trained textual-inversion vectors -> one a1111 file per
  keyword.

Either package's checkpoints are read: both store ``unet.``,
``condition_model.encoder{,_2,_3}.`` and ``unet_ema.shadow_params.``. The
text encoder keeps the ``text_model`` segment every original SD1.x
checkpoint has (``cond_stage_model.transformer.text_model.*``), as WebUI's
FrozenCLIPEmbedder expects. Tensors stay on the CPU.
"""

from __future__ import annotations

import logging
from functools import lru_cache
from pathlib import Path
from typing import Optional

import click
import torch

from ..conf import Config, get_ldm_config, load as conf_load, load_optim_target, search_key
from ..convert.kohya import to_kohya_format
from ..convert.loader import _find_weights_file
from ..convert.sd_names import (
    apply_renames,
    convert_transformers_text_to_openclip,
    convert_unet_state_df_to_ldm,
    convert_unet_state_ldm_to_df,
    convert_vae_state_df_to_ldm,
    infer_unet_layout,
    normalize_df_vae_attention,
    unet_prefix_map,
)
from ..models.unet import UNetConfig
from ..utils.state import (
    DTYPE_MAP,
    SUPPORTED_FORMATS,
    cast_type,
    load_state_dict,
    replace_prefix,
    save_state_dict,
    where_prefix,
)

logger = logging.getLogger("ckpt-tool")

UNET_CKPT_PREFIX = "unet."
TE_CKPT_PREFIX = "condition_model.encoder."
TE2_CKPT_PREFIX = "condition_model.encoder_2."   # SDXL's / SD3's tower 2
TE3_CKPT_PREFIX = "condition_model.encoder_3."   # SD3's T5
EMA_CKPT_PREFIX = "unet_ema.shadow_params."
# the dtypes `lora` casts: numpy's floating kinds, which the JAX tool casts
# (its bf16 factors, an ml_dtypes type, pass through uncast)
_LORA_CAST = (torch.float16, torch.float32, torch.float64)


def check_overwrite(path: Path, overwrite: bool):
    if path.exists() and not overwrite:
        raise FileExistsError(f"{path} already exists")


def _no_lora(state: dict) -> dict:
    return {k: v for k, v in state.items() if ".lora_" not in k}


def _ldm_vae(vae: Optional[Path], df_vae: Optional[str]) -> Optional[dict]:
    """The VAE under ``first_stage_model.`` from an LDM file (a first stage
    alone or a checkpoint holding one) or a diffusers VAE directory."""
    if vae is not None:
        state = load_state_dict(vae)
        return where_prefix(state, "first_stage_model.") or replace_prefix(
            state, "", "first_stage_model.")
    if df_vae is not None:
        state = normalize_df_vae_attention(load_state_dict(_find_weights_file(Path(df_vae))))
        return replace_prefix(convert_vae_state_df_to_ldm(state), "", "first_stage_model.")
    return None


@click.group()
def main():
    pass


@main.command()
@click.argument("checkpoint", type=click.Path(exists=True, dir_okay=False, path_type=Path))
@click.argument("output", type=click.Path(path_type=Path))
@click.option("--unet-dtype", type=click.Choice(list(DTYPE_MAP)), default="fp16",
              help="Save UNet weights in this data type.")
@click.option("--text-encoder", is_flag=True, help="Include text encoder weights.")
@click.option("--text-encoder-dtype", type=click.Choice(list(DTYPE_MAP)), default="fp16")
@click.option("--vae", type=click.Path(exists=True, dir_okay=False, path_type=Path),
              help="Include VAE weights from an LDM VAE file or checkpoint containing one.")
@click.option("--df-vae", type=str, help="Include VAE weights from a diffusers VAE directory.")
@click.option("--vae-dtype", type=click.Choice(list(DTYPE_MAP)), default="fp32")
@click.option("--overwrite", is_flag=True)
@click.option("--format", "fmt", type=click.Choice(SUPPORTED_FORMATS), default=None)
@click.option("--ema", is_flag=True, help="Use EMA weights.")
@click.option("--pristine-te", type=str, default=None,
              help="Pristine CLIP text-encoder source (diffusers text_encoder dir, "
                   "transformers dir, or weights file) used when the checkpoint has no TE "
                   "weights. Defaults to the local transformers cache of "
                   "openai/clip-vit-large-patch14.")
@click.option("--arch", type=click.Choice(["auto", "sd1", "sd2", "sdxl", "sd3"]),
              default="auto", show_default=True,
              help="Architecture for the LDM name bijection and the text-encoder namespace. "
                   "'auto' infers the UNet layout from the checkpoint's keys and detects the "
                   "SD2 OpenCLIP tower by width; pass explicitly for partial (e.g. KV-only) "
                   "checkpoints.")
@click.option("--pos-embed-max-size", type=int, default=192, show_default=True,
              help="SD3 sgm layout only: grid size of the synthesized sincos pos_embed buffer "
                   "when the training checkpoint omits it (trainable-only checkpoints always "
                   "do; 192 = SD3-Medium).")
@click.option("--layout", type=click.Choice(["diffusers", "sgm"]), default="diffusers",
              show_default=True,
              help="SD3 output layout: 'diffusers' emits the bare SD3Transformer2DModel file "
                   "(drop into <model>/transformer/); 'sgm' emits a WebUI/ComfyUI single-file "
                   "checkpoint (model.diffusion_model.* joint_blocks, text_encoders.clip_l/"
                   "clip_g towers). Ignored for SD1/SD2/SDXL (always single-file LDM).")
def prune(checkpoint: Path, output: Path, unet_dtype: str, text_encoder: bool,
          text_encoder_dtype: str, vae: Optional[Path], df_vae: Optional[str], vae_dtype: str,
          overwrite: bool, fmt: Optional[str], ema: bool, pristine_te: Optional[str], arch: str,
          layout: str, pos_embed_max_size: int):
    """Convert a training checkpoint for CompVis/StabilityAI LDM codebases."""
    check_overwrite(output, overwrite)
    if vae and df_vae:
        raise click.UsageError("Only one of --vae / --df-vae may be given")

    state = load_state_dict(checkpoint)
    # UNet (the EMA shadow's keys are relative to the UNet)
    if ema:
        unet_state = replace_prefix(state, EMA_CKPT_PREFIX)
        if not unet_state:
            raise ValueError("Checkpoint has no EMA weights")
    else:
        unet_state = replace_prefix(state, UNET_CKPT_PREFIX)
    unet_state = _no_lora(unet_state)
    if arch == "sd3" or (arch == "auto" and "pos_embed.proj.weight" in unet_state):
        _prune_sd3(state, unet_state, output, unet_dtype, text_encoder, text_encoder_dtype, vae,
                   df_vae, vae_dtype, fmt, layout, pos_embed_max_size)
        return

    user_arch = arch   # an explicit choice also decides the TE namespace
    inferred = infer_unet_layout(unet_state) if arch == "auto" else None
    if inferred is not None:
        # a whole state: index the bijection by its own block structure
        map_config = inferred
        arch = "sdxl" if inferred.addition_embed_type == "text_time" else "sd1"
    else:
        # a partial (e.g. KV-only) state is ambiguous: the canonical
        # architecture of --arch
        if arch == "auto":
            arch = "sdxl" if any(
                k.startswith(("add_embedding.", "mid_block.attentions.0.transformer_blocks.1."))
                for k in unet_state) else "sd1"
        map_config = UNetConfig.sdxl() if arch == "sdxl" else UNetConfig.sd15()
    sd2_te = user_arch == "sd2" or (user_arch == "auto" and arch != "sdxl"
                                    and _looks_sd2_te(state))
    ldm_state = cast_type(replace_prefix(convert_unet_state_df_to_ldm(unet_state, map_config),
                                         "", "model.diffusion_model."), unet_dtype)

    vae_state = _ldm_vae(vae, df_vae)
    if vae_state is not None:
        ldm_state.update(cast_type(vae_state, vae_dtype))

    if text_encoder and arch == "sdxl":
        # WebUI's SDXL single file: tower 1 (transformers layout) under
        # conditioner.embedders.0.transformer, tower 2 in OpenCLIP naming
        # under conditioner.embedders.1.model
        te1 = _no_lora(replace_prefix(state, TE_CKPT_PREFIX,
                                      "conditioner.embedders.0.transformer."))
        te2 = _no_lora(replace_prefix(state, TE2_CKPT_PREFIX))
        if not te1 or not te2:
            logger.warning("Checkpoint lacks full SDXL text towers (trainable-only checkpoints "
                           "omit frozen components); skipping --text-encoder — merge into a "
                           "full model with `graft` instead")
        else:
            ldm_state.update(cast_type(te1, text_encoder_dtype))
            ldm_state.update(cast_type(replace_prefix(convert_transformers_text_to_openclip(te2),
                                                      "", "conditioner.embedders.1.model."),
                                       text_encoder_dtype))
    elif text_encoder and sd2_te:
        # SD2.x: the tower in OpenCLIP naming under cond_stage_model.model
        te = _no_lora(replace_prefix(state, TE_CKPT_PREFIX))
        if not te:
            logger.warning("Checkpoint lacks text-encoder weights; skipping --text-encoder "
                           "(merge via `graft` instead)")
        else:
            ldm_state.update(cast_type(replace_prefix(convert_transformers_text_to_openclip(te),
                                                      "", "cond_stage_model.model."),
                                       text_encoder_dtype))
    elif text_encoder:
        te_state = _no_lora(replace_prefix(state, TE_CKPT_PREFIX,
                                           "cond_stage_model.transformer."))
        if not te_state:
            te_state = replace_prefix(_pristine_clip_state(pristine_te), "",
                                      "cond_stage_model.transformer.")
            logger.info("Checkpoint has no text-encoder weights; using pristine CLIP-L")
        ldm_state.update(cast_type(te_state, text_encoder_dtype))

    save_state_dict(ldm_state, output, fmt)
    logger.info(f"Wrote {len(ldm_state)} tensors to {output}")


def _prune_sd3(state: dict, unet_state: dict, output: Path, unet_dtype: str,
               text_encoder: bool, text_encoder_dtype: str, vae: Optional[Path],
               df_vae: Optional[str], vae_dtype: str, fmt: Optional[str], layout: str,
               pos_embed_max_size: int):
    """SD3's prune: the bare transformer in diffusers naming, or (``--layout
    sgm``) the WebUI / ComfyUI single file: the MMDiT in sgm naming under
    ``model.diffusion_model.``, the towers (transformers layout) under
    ``text_encoders.{clip_l,clip_g,t5xxl}.transformer.``."""
    if layout != "sgm":
        out_state = cast_type(unet_state, unet_dtype)
        save_state_dict(out_state, output, fmt)
        logger.info(f"Saved SD3 transformer ({len(out_state)} tensors, {unet_dtype}) in "
                    f"diffusers layout to {output}")
        return
    from ..convert.mmdit_names import convert_mmdit_state_df_to_sgm
    from ..models.mmdit import POS_EMBED_KEY, sincos_pos_embed_2d

    if POS_EMBED_KEY not in unet_state:
        # training checkpoints leave the fixed sincos buffer out; single
        # files carry it
        inner = int(unet_state["pos_embed.proj.weight"].shape[0])
        unet_state[POS_EMBED_KEY] = sincos_pos_embed_2d(inner, pos_embed_max_size)
    ldm_state = cast_type(replace_prefix(convert_mmdit_state_df_to_sgm(unet_state), "",
                                         "model.diffusion_model."), unet_dtype)
    if df_vae is not None:
        raise click.UsageError("--df-vae is not supported with --layout sgm for SD3; pass an "
                               "LDM-layout VAE file via --vae instead")
    vae_state = _ldm_vae(vae, None)
    if vae_state is not None:
        ldm_state.update(cast_type(vae_state, vae_dtype))
    if text_encoder:
        te1 = _no_lora(replace_prefix(state, TE_CKPT_PREFIX, "text_encoders.clip_l.transformer."))
        te2 = _no_lora(replace_prefix(state, TE2_CKPT_PREFIX,
                                      "text_encoders.clip_g.transformer."))
        if not te1 or not te2:
            logger.warning("Checkpoint lacks full SD3 text towers (trainable-only checkpoints "
                           "omit frozen components); skipping --text-encoder — merge into a "
                           "full model with `graft`")
        else:
            ldm_state.update(cast_type(te1, text_encoder_dtype))
            ldm_state.update(cast_type(te2, text_encoder_dtype))
            te3 = _no_lora(replace_prefix(state, TE3_CKPT_PREFIX,
                                          "text_encoders.t5xxl.transformer."))
            if te3:
                ldm_state.update(cast_type(te3, text_encoder_dtype))
    elif where_prefix(state, TE3_CKPT_PREFIX):
        logger.warning("Checkpoint contains a T5 tower (condition_model.encoder_3.*) but "
                       "--text-encoder was not given; it is NOT included in the published "
                       "single file")
    save_state_dict(ldm_state, output, fmt)
    logger.info(f"Wrote {len(ldm_state)} tensors (SD3 single-file sgm layout) to {output}")


def _looks_sd2_te(state: dict) -> bool:
    """SD2.x's text tower: an OpenCLIP-H-wide (1024) token embedding in the
    checkpoint's text-encoder namespace."""
    tok = state.get(TE_CKPT_PREFIX + "text_model.embeddings.token_embedding.weight")
    return tok is not None and int(tok.shape[1]) >= 1024


def _pristine_clip_state(source: Optional[str]) -> dict:
    """A pristine CLIP-L text model in transformers naming (``text_model.*``)
    from a local directory or file, or else from transformers' local cache
    of openai/clip-vit-large-patch14 (never the network)."""
    if source is not None:
        src = Path(source)
        if src.is_dir():
            if (src / "text_encoder").is_dir():
                src = src / "text_encoder"
            state = load_state_dict(_find_weights_file(src))
        else:
            state = load_state_dict(src)
    else:
        try:
            from transformers import CLIPTextModel

            model = CLIPTextModel.from_pretrained("openai/clip-vit-large-patch14",
                                                  local_files_only=True)
            state = {k: v.detach() for k, v in model.state_dict().items()}
        except Exception as e:
            raise click.ClickException(
                "Checkpoint has no text-encoder weights and no pristine CLIP-L is available "
                f"offline; pass --pristine-te with a local text-encoder dir or weights file "
                f"({e})")
    state = {k: v for k, v in state.items()
             if not k.endswith("position_ids") and ".lora_" not in k}
    if not any(k.startswith("text_model.") for k in state):
        state = {f"text_model.{k}": v for k, v in state.items()}
    return state


@main.command("lora")
@click.argument("checkpoint", type=click.Path(exists=True, dir_okay=False, path_type=Path))
@click.argument("output", type=click.Path(path_type=Path))
@click.option("--overwrite", is_flag=True)
@click.option("--format", "fmt", type=click.Choice(SUPPORTED_FORMATS), default=None)
@click.option("--dtype", type=click.Choice(list(DTYPE_MAP)), default="fp16")
@click.option("--unet-naming", type=click.Choice(["auto", "diffusers", "ldm"]), default="auto",
              show_default=True,
              help="UNet module naming in the exported keys. kohya's SD1.x LoRAs use "
                   "diffusers-style names (lora_unet_down_blocks_*) but its SDXL LoRAs use "
                   "sgm/LDM-style (lora_unet_input_blocks_*); 'auto' picks by whether the "
                   "checkpoint trains the second text tower.")
def extract_lora_cmd(checkpoint: Path, output: Path, overwrite: bool, fmt: Optional[str],
                     dtype: str, unet_naming: str):
    """Export trained LoRA factors in kohya/AddNet-compatible format."""
    check_overwrite(output, overwrite)

    def get_alpha():
        run_config = checkpoint.parent / "config.yaml"
        if not run_config.exists():
            logger.warning("No run config next to checkpoint; alpha defaults off")
            return None
        optim_target = conf_load(run_config).optim_target
        if isinstance(optim_target, str):
            optim_target = load_optim_target(optim_target)
        return next(search_key(optim_target, "lora"), {}).get("alpha")

    state = load_state_dict(checkpoint)
    unet = replace_prefix(state, UNET_CKPT_PREFIX)
    te = replace_prefix(state, TE_CKPT_PREFIX)
    te2 = replace_prefix(state, TE2_CKPT_PREFIX)
    if unet_naming == "auto":
        unet_naming = "ldm" if te2 else "diffusers"
    if unet_naming == "ldm":
        # kohya's SDXL UNet is sgm-style: its keys flatten LDM module paths
        # (lora_unet_input_blocks_4_1_...)
        pairs = unet_prefix_map(UNetConfig.sdxl())
        unet = {apply_renames(k, pairs): v for k, v in unet.items()}
    result = to_kohya_format(unet, "lora_unet", get_alpha())
    if te2:
        # kohya's SDXL convention: the towers as lora_te1_ / lora_te2_
        result.update(to_kohya_format(te, "lora_te1", get_alpha()))
        result.update(to_kohya_format(te2, "lora_te2", get_alpha()))
    else:
        result.update(to_kohya_format(te, "lora_te", get_alpha()))

    cast = {k: v.to(DTYPE_MAP[dtype]) if v.dtype in _LORA_CAST else v
            for k, v in result.items()}
    save_state_dict(cast, output, fmt)
    logger.info(f"Wrote {len(cast)} LoRA tensors to {output}")


def load_as_diffusers_state(path: Path, ldm_config_path: Optional[str] = None
                            ) -> tuple[dict, dict]:
    """(unet_state, clip_state) in diffusers names, from a diffusers
    directory or an LDM single file (shaped by ``ldm_config_path``, the
    bundled v1 YAML by default; its text tower is read from
    ``cond_stage_model.transformer.`` only, so an SD2 file gives none)."""
    path = Path(path)
    if path.is_dir():
        unet_state = load_state_dict(_find_weights_file(path / "unet"))
        clip_state = load_state_dict(_find_weights_file(path / "text_encoder"))
    else:
        state = load_state_dict(path)
        cfg = UNetConfig.from_ldm_config(get_ldm_config(ldm_config_path))
        unet_state = convert_unet_state_ldm_to_df(replace_prefix(state, "model.diffusion_model."),
                                                  cfg)
        clip_state = replace_prefix(state, "cond_stage_model.transformer.")
    clip_state.pop("text_model.embeddings.position_ids", None)
    return unet_state, clip_state


@main.command("graft")
@click.argument("base_model_path", type=click.Path(exists=True, path_type=Path), nargs=1)
@click.argument("model_paths", type=click.Path(exists=True, path_type=Path), nargs=-1)
@click.argument("output_path", type=click.Path(path_type=Path), nargs=1)
@click.option("--layer-spec", type=click.Path(exists=True, path_type=Path), required=True,
              help="Layer specification (see configs/optim_targets).")
@click.option("--overwrite", is_flag=True)
@click.option("--format", "fmt", type=click.Choice(SUPPORTED_FORMATS), default=None)
@click.option("--unet-dtype", type=click.Choice(list(DTYPE_MAP)), default="fp32")
@click.option("--text-encoder-dtype", type=click.Choice(list(DTYPE_MAP)), default="fp32")
@click.option("--lru-cache-size", type=int, default=3)
@click.option("--ldm-config", type=str, default=None)
def graft(base_model_path: Path, model_paths: tuple[Path, ...], output_path: Path,
          layer_spec: Path, overwrite: bool, fmt: Optional[str], unet_dtype: str,
          text_encoder_dtype: str, lru_cache_size: int, ldm_config: Optional[str]):
    """Graft submodule subtrees from other models onto a base model."""
    check_overwrite(output_path, overwrite)
    layer_config = conf_load(layer_spec)
    base_unet, base_clip = load_as_diffusers_state(base_model_path, ldm_config)
    cached_load = lru_cache(maxsize=lru_cache_size)(
        lambda p: load_as_diffusers_state(Path(p), ldm_config))

    for comp_idx, (comp_name, base_state) in enumerate([("unet", base_unet),
                                                         ("text_encoder", base_clip)]):
        section = layer_config.get(comp_name)
        if section is not None:
            _graft_walk(section.targets, "", base_state, model_paths, cached_load, comp_idx)

    ldm_state = cast_type(replace_prefix(convert_unet_state_df_to_ldm(base_unet), "",
                                         "model.diffusion_model."), unet_dtype)
    ldm_state.update(cast_type(replace_prefix(base_clip, "", "cond_stage_model.transformer."),
                               text_encoder_dtype))
    save_state_dict(ldm_state, output_path, fmt)
    logger.info(f"Wrote grafted model ({len(ldm_state)} tensors) to {output_path}")


def _graft_walk(nodes, prefix, base_state, model_paths, cached_load, comp_idx):
    keys = list(base_state.keys())

    def children(pfx):
        start = pfx + "." if pfx else ""
        seen = {}
        for k in keys:
            if k.startswith(start) and "." in k[len(start):]:
                seen.setdefault(k[len(start):].split(".", 1)[0])
        return list(seen)

    for node in nodes:
        node = node if isinstance(node, Config) else Config(node or {})
        index = node.get("index")
        targets = node.get("targets")
        for path in (children(prefix) if index is None else list(index)):
            sub = f"{prefix}.{path}" if prefix else path
            if targets is not None:
                _graft_walk(targets, sub, base_state, model_paths, cached_load, comp_idx)
                continue
            source = node.get("source")
            if source is None:
                continue
            donor = cached_load(str(model_paths[int(source)]))[comp_idx]
            n = 0
            for k in keys:
                if k.startswith(sub + "."):
                    base_state[k] = donor[k]
                    n += 1
            logger.info(f"Grafted {sub} ({n} tensors) from model [{source}]")


@main.command("embedding")
@click.argument("checkpoint", type=click.Path(exists=True, dir_okay=False, path_type=Path))
@click.argument("out_dir", type=click.Path(file_okay=False, path_type=Path))
def embedding(checkpoint: Path, out_dir: Path):
    """Export trained textual-inversion embeddings to a1111-layout safetensors
    (one file per keyword), which WebUI and ``custom_embeddings.path`` read."""
    from ..text.ti import TRAINED_EXTRA_KEY, export_embeddings
    from ..training.checkpoint import load_checkpoint_tensors
    from ..training.step import TE_PREFIX

    tensors, meta = load_checkpoint_tensors(checkpoint)
    key = f"{TE_PREFIX}.{TRAINED_EXTRA_KEY}"
    if key not in tensors or not meta.get("ti_tokens"):
        raise click.UsageError(
            f"{checkpoint} contains no trained textual-inversion vectors (need tensor {key!r} "
            "+ ti_tokens metadata)")
    for p in export_embeddings(tensors[key], meta["ti_tokens"], out_dir):
        logger.info(f"Wrote {p}")


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main()
