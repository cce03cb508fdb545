"""Declarative optim-target resolution over flat parameter names (port of
``scal_sdt_tpu/training/optim_targets.py``).

A ``targets:`` spec (the original trainer's ``{index, targets, recurse_conf}``
schema) resolves against the dotted keys of the flat param dict: "submodule"
is "key prefix". The result is the trainable keys, ordered param groups with
optimizer overrides, and the LoRA specs of the modules a ``lora:`` node
names: such a module trains its ``lora_A`` / ``lora_B`` factors (injected by
``training/lora.py``), one group per module. The fixed buffers in
``BUFFERS`` (the MMDiT's sincos ``pos_embed``) never become trainable, even
under a target that selects their module.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from ..conf import Config, merge

# Checkpoint namespace of each component, as in the JAX training step.
COMPONENT_PREFIX = {"unet": "unet", "text_encoder": "condition_model.encoder",
                    "text_encoder_2": "condition_model.encoder_2",
                    "text_encoder_3": "condition_model.encoder_3"}

# Fixed buffers that never train even when a target's subtree selects them
# (torch registers them as buffers, not parameters): the MMDiT's sincos
# positional table (diffusers PatchEmbed.pos_embed).
BUFFERS = ("pos_embed.pos_embed",)


@dataclasses.dataclass(frozen=True)
class LoRASpec:
    rank: int = 4
    alpha: float = 1.0
    dropout: float = 0.0


@dataclasses.dataclass
class ParamGroup:
    """One optimizer group: trainable keys + optimizer kwarg overrides."""
    keys: list[str]
    optimizer: dict


@dataclasses.dataclass
class TargetResolution:
    trainable: list[str]
    groups: list[ParamGroup]
    lora: dict[str, LoRASpec] = dataclasses.field(default_factory=dict)  # module path -> spec


def _children(param_keys: list[str], prefix: str) -> list[str]:
    """Distinct next path segments under `prefix` (module-tree children)."""
    start = prefix + "." if prefix else ""
    seen: dict[str, None] = {}
    for k in param_keys:
        if not k.startswith(start):
            continue
        rest = k[len(start):]
        if "." in rest:  # only keys with deeper structure form child modules
            seen.setdefault(rest.split(".", 1)[0])
    return list(seen)


def _join(prefix: str, path: str) -> str:
    return f"{prefix}.{path}" if prefix else path


def _module_param_keys(param_keys: list[str], prefix: str) -> list[str]:
    start = prefix + "." if prefix else ""
    return [k for k in param_keys if k.startswith(start)]


def resolve_targets(component_targets: list, param_keys: Iterable[str]) -> TargetResolution:
    """Resolve a `targets:` list for one component (unet / text_encoder)."""
    param_keys = list(param_keys)
    result = TargetResolution(trainable=[], groups=[])

    def leaf(prefix: str, node_config: Config):
        lora = node_config.get("lora")
        if lora is not None:
            if f"{prefix}.weight" not in param_keys:
                raise KeyError(f"LoRA target {prefix} has no weight parameter")
            result.lora[prefix] = LoRASpec(rank=int(lora.get("rank", 4)),
                                           alpha=float(lora.get("alpha", 1)),
                                           dropout=float(lora.get("dropout", 0.0)))
            keys = [f"{prefix}.lora_A", f"{prefix}.lora_B"]
        else:
            keys = [k for k in _module_param_keys(param_keys, prefix)
                    if k not in BUFFERS and not k.endswith(tuple("." + b for b in BUFFERS))]
            if not keys:
                raise KeyError(f"Optim target {prefix} matches no parameters")
        result.trainable.extend(keys)
        result.groups.append(ParamGroup(keys=keys,
                                        optimizer=dict(node_config.get("optimizer", {}))))

    def walk(prefix: str, nodes: list, recurse_conf: Optional[Config]):
        for node in nodes:
            node = node if isinstance(node, Config) else Config(node or {})
            index = node.get("index")
            targets = node.get("targets")

            # recurse_conf persists across sibling nodes, as in the original
            # trainer's loop-scoped accumulation.
            own_rc = node.get("recurse_conf")
            if recurse_conf is None:
                recurse_conf = own_rc
            elif own_rc is not None:
                recurse_conf = merge(recurse_conf, own_rc)
            rc = recurse_conf

            if index is None:
                selected = _children(param_keys, prefix)
                if not selected and targets is None:
                    selected = [None]  # the module itself is the leaf
            else:
                selected = list(index)

            optional = bool(node.get("optional", False))
            for path in selected:
                sub = prefix if path is None else _join(prefix, path)
                if optional and index is not None and not _module_param_keys(param_keys, sub):
                    continue
                if targets is not None:
                    walk(sub, targets, rc)
                else:
                    leaf(sub, node if rc is None else merge(node, rc))

    walk("", component_targets, None)
    return result


def resolve_optim_target(optim_target: Config, unet_keys: Iterable[str],
                         text_encoder_keys: Iterable[str],
                         text_encoder_2_keys: Optional[Iterable[str]] = None
                         ) -> dict[str, TargetResolution]:
    """Resolve the full optim-target spec: 'unet' / 'text_encoder' (and, for
    SDXL models, 'text_encoder_2') resolutions; components absent from the
    spec get an empty resolution (frozen)."""
    components = [("unet", unet_keys), ("text_encoder", text_encoder_keys)]
    if text_encoder_2_keys is not None:
        components.append(("text_encoder_2", text_encoder_2_keys))
    out = {}
    for name, keys in components:
        section = optim_target.get(name)
        out[name] = (TargetResolution(trainable=[], groups=[]) if section is None
                     else resolve_targets(section.targets, keys))
    if text_encoder_2_keys is None and optim_target.get("text_encoder_2"):
        raise ValueError("optim target addresses text_encoder_2 but the loaded model has no "
                         "second text tower (not SDXL)")
    return out


def group_labels(resolutions: dict[str, TargetResolution]) -> dict[str, str]:
    """Prefixed trainable key ('unet.' / 'condition_model.encoder.' /
    'condition_model.encoder_2.') -> group label 'g<N>'."""
    labels: dict[str, str] = {}
    g = 0
    for comp, res in resolutions.items():
        prefix = COMPONENT_PREFIX[comp]
        for group in res.groups:
            for k in group.keys:
                labels[f"{prefix}.{k}"] = f"g{g}"
            g += 1
    return labels
