"""Flat state-dict IO on torch tensors (port of ``scal_sdt_tpu/utils/state.py``).

Load and save ``.safetensors`` files (with the JSON metadata blob the cache
and checkpoints carry) and torch ``.pt/.ckpt`` files as flat
``{dotted.name: torch.Tensor}`` dicts on the CPU, plus the prefix-surgery and
dtype-casting helpers the checkpoint tools use. The JAX package keeps numpy
arrays instead; the files are the same, so either package reads the other's.

A ``.pt/.ckpt`` file is read with ``torch.load(weights_only=True)``: tensors
and plain containers only, no arbitrary pickled objects. A Lightning
checkpoint that pickles other objects is refused (full checkpoint reading
comes with the trainer port).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import torch

State = dict[str, torch.Tensor]

SUPPORTED_FORMATS = ["pt", "safetensors"]

DTYPE_MAP = {
    "fp16": torch.float16,
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
}


def infer_format(path: Union[str, Path]) -> Optional[str]:
    suffix = Path(path).suffix[1:].lower()
    if suffix in ("ckpt", "pt"):
        return "pt"
    if suffix == "safetensors":
        return "safetensors"
    return None


def _checked_format(path: Path, _format: Optional[str]) -> str:
    _format = _format or infer_format(path)
    if _format not in SUPPORTED_FORMATS:
        raise ValueError(f"Unsupported state format for {path}")
    return _format


def load_state_dict(path: Union[str, Path], _format: Optional[str] = None) -> State:
    path = Path(path)
    if _checked_format(path, _format) == "pt":
        state = torch.load(path, map_location="cpu", weights_only=True)
        state = state.get("state_dict", state)
        return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}

    from safetensors.torch import load_file

    return load_file(str(path), device="cpu")


def load_metadata(path: Union[str, Path]) -> Optional[dict[str, str]]:
    from safetensors import safe_open

    with safe_open(str(path), framework="pt") as f:
        return f.metadata()


def save_state_dict(state: State, path: Union[str, Path], _format: Optional[str] = None,
                    metadata: Optional[dict[str, str]] = None):
    path = Path(path)
    out = {k: v.detach().cpu().contiguous() for k, v in state.items()}
    if _checked_format(path, _format) == "pt":
        with open(path, "wb") as f:
            torch.save({"state_dict": out}, f)
        return

    from safetensors.torch import save_file

    save_file(out, str(path), metadata=metadata)


def where_prefix(state: State, prefix: str = "") -> State:
    return {k: v for k, v in state.items() if k.startswith(prefix)}


def replace_prefix(state: State, prefix: str = "", replacement: str = "") -> State:
    return {
        replacement + k[len(prefix):]: v
        for k, v in state.items()
        if k.startswith(prefix)
    }


def cast_type(state: State, dtype: Union[str, torch.dtype]) -> State:
    if isinstance(dtype, str):
        dtype = DTYPE_MAP[dtype]
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}


def save_json_metadata(meta: dict) -> dict[str, str]:
    return {"json": json.dumps(meta)}
