"""kohya/AddNet LoRA files: export and import (port of
``scal_sdt_tpu/convert/kohya.py`` and of ``to_kohya_format`` in
``scal_sdt_tpu/cli/ckpt_tool.py``).

``to_kohya_format`` names the trainer's LoRA factors as AddNet does
(``ckpt_tool lora``); ``from_kohya_format`` lets ``cli.sample --ckpt``
consume LoRA files from the wider kohya/WebUI ecosystem, not just the
trainer's own checkpoints. The flattened underscore
names (``lora_unet_down_blocks_0_attentions_...``) are resolved back to
dotted module paths by matching against the loaded model's parameter names
(inversion by string surgery alone is ambiguous: path segments contain
underscores). SDXL files name the second text tower ``lora_te2_`` and the
UNet in the LDM dialect (``lora_unet_input_blocks_4_1_...``), since kohya's
SDXL UNet is sgm-style.
"""

from __future__ import annotations

import logging
from typing import Iterable, Optional

import torch

logger = logging.getLogger("kohya")

_LEAF_MAP = {"lora_down.weight": "lora_A", "lora_up.weight": "lora_B",
             "alpha": "lora_alpha"}


def to_kohya_format(state: dict, prefix: str, fallback_alpha=None) -> dict:
    """LoRA factors (``{module}.lora_A`` / ``lora_B`` / ``lora_alpha``) ->
    AddNet names (``{prefix}_{module with _}.lora_down.weight`` / ``lora_up.weight``
    / ``alpha``). A module without a stored alpha gets ``fallback_alpha``
    (int32, 0-dim) when one is given; ``state`` takes it too."""
    modules = {k.rsplit(".", 1)[0] for k in state if k.endswith((".lora_A", ".lora_B"))}
    out = {}
    for module in modules:
        if f"{module}.lora_alpha" not in state and fallback_alpha is not None:
            state[f"{module}.lora_alpha"] = torch.tensor(int(fallback_alpha), dtype=torch.int32)
        name = "_".join([prefix] + module.split("."))
        for kohya_leaf, leaf in _LEAF_MAP.items():
            k = f"{module}.{leaf}"
            if k in state:
                out[f"{name}.{kohya_leaf}"] = state[k]
    return out


def is_kohya_lora(state: dict) -> bool:
    return any(k.startswith(("lora_unet_", "lora_te_", "lora_te1_", "lora_te2_"))
               for k in state)


def _module_paths(param_names: Iterable[str]) -> dict[str, str]:
    """flattened underscore name -> dotted module path, for every module
    (= prefix of a '.weight' param) of a component."""
    out = {}
    for n in param_names:
        if n.endswith(".weight"):
            path = n[: -len(".weight")]
            out[path.replace(".", "_")] = path
    return out


def _unet_module_paths(param_names: Iterable[str]) -> dict[str, str]:
    """UNet modules under both naming dialects: diffusers-style flats (kohya
    SD1.x LoRAs) and LDM-style flats (``lora_unet_input_blocks_4_1_...``),
    resolved through the diffusers -> LDM prefix pairs of the UNet's own
    block structure."""
    from .sd_names import apply_renames, infer_unet_layout, unet_prefix_map

    names = list(param_names)
    out = _module_paths(names)
    layout = infer_unet_layout(names)
    if layout is not None:
        pairs = unet_prefix_map(layout)
        for path in list(out.values()):
            ldm_path = apply_renames(path + ".", pairs)[:-1]
            out.setdefault(ldm_path.replace(".", "_"), path)
    return out


def from_kohya_format(state: dict, unet_names: Iterable[str], te_names: Iterable[str],
                      te2_names: Optional[Iterable[str]] = None) -> dict:
    """kohya LoRA state -> the trainer's prefixed checkpoint tensors
    (``unet.{path}.lora_A`` and so on), consumable by the same merge as
    training checkpoints; ``te2_names``: SDXL's second tower. Unresolvable
    modules raise (a silently skipped LoRA is worse than an error)."""
    from ..training.step import TE2_PREFIX, TE_PREFIX, UNET_PREFIX

    maps = {
        "lora_unet": (UNET_PREFIX, _unet_module_paths(unet_names)),
        "lora_te1": (TE_PREFIX, _module_paths(te_names)),
        "lora_te": (TE_PREFIX, _module_paths(te_names)),
    }
    if te2_names is not None:
        maps["lora_te2"] = (TE2_PREFIX, _module_paths(te2_names))

    out: dict = {}
    unresolved = []
    for k, v in state.items():
        matched = False
        for kohya_prefix in sorted(maps, key=len, reverse=True):
            if not k.startswith(kohya_prefix + "_"):
                continue
            matched = True
            ckpt_prefix, paths = maps[kohya_prefix]
            rest = k[len(kohya_prefix) + 1:]
            if "." not in rest:
                unresolved.append(k)
                break
            flat, leaf = rest.split(".", 1)
            path = paths.get(flat)
            if leaf not in _LEAF_MAP or path is None:
                unresolved.append(k)
                break
            t = torch.as_tensor(v)
            if t.dim() == 4:
                if tuple(t.shape[2:]) != (1, 1):
                    raise ValueError(
                        f"{k}: 3x3-conv LoRA is not supported (LoRA applies to Linear and "
                        f"1x1-conv modules, like the reference's loralib usage)")
                t = t.reshape(t.shape[0], t.shape[1])
            if leaf == "alpha":
                t = torch.tensor(int(t), dtype=torch.int32)
            out[f"{ckpt_prefix}.{path}.{_LEAF_MAP[leaf]}"] = t
            break
        if not matched and k.startswith("lora_"):
            unresolved.append(k)
    if unresolved:
        raise ValueError(
            f"kohya LoRA: {len(unresolved)} keys could not be resolved against the loaded "
            f"model, e.g. {sorted(unresolved)[:4]} (wrong base model or unsupported module "
            f"set)")
    logger.info(f"Imported {len(out)} kohya LoRA tensors")
    return out
