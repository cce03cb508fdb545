"""Flat state-dict IO on torch tensors (port of ``scal_sdt_tpu/utils/state.py``).

Load and save ``.safetensors`` files (with the JSON metadata blob the cache
and checkpoints carry) and torch ``.pt/.ckpt`` files as flat
``{dotted.name: torch.Tensor}`` dicts on the CPU, plus the prefix-surgery and
dtype-casting helpers the checkpoint tools use. The JAX package keeps numpy
arrays instead; the files are the same, so either package reads the other's.

A ``.pt/.ckpt`` file is read with ``torch.load(weights_only=True)`` first.
A Lightning checkpoint whose pickle names other classes (the original SD 1.x
``.ckpt`` files name ``pytorch_lightning`` callbacks) is then read with a
restricted unpickler: torch's tensor-rebuild functions, dtypes and storages
pass through, and every other global the pickle names becomes an inert
placeholder that is neither imported nor called. So the port gets the
tensors the JAX package's ``torch.load(weights_only=False)`` gets, and runs
no code from the file.
"""

from __future__ import annotations

import json
import pickle
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


class _Inert:
    """Stands in for a global a checkpoint's pickle names: it takes any
    arguments and state and does nothing with them."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


# the globals a tensor's pickle names besides its storage (which torch.load
# resolves itself): the rebuild functions and the classes they take
_TENSOR_GLOBALS = {
    ("torch._utils", "_rebuild_tensor"), ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_parameter"), ("torch._utils", "_rebuild_parameter_with_state"),
    ("torch._tensor", "_rebuild_from_type_v2"), ("torch", "Tensor"), ("torch", "Size"),
    ("torch.nn.parameter", "Parameter"), ("collections", "OrderedDict"),
}


class _TensorOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _TENSOR_GLOBALS:
            return getattr(__import__(module, fromlist=[name]), name)
        if module == "torch" and isinstance(getattr(torch, name, None), torch.dtype):
            return getattr(torch, name)
        return type(name, (_Inert,), {"__module__": "inert." + module})


class _TensorOnlyPickle:
    """A ``pickle_module`` for ``torch.load`` whose unpickler is
    ``_TensorOnlyUnpickler``, for the main object and for the header
    pickles a legacy (non-zip) file carries before it alike."""
    Unpickler = _TensorOnlyUnpickler
    load = staticmethod(lambda f, **kwargs: _TensorOnlyUnpickler(f, **kwargs).load())
    __name__ = "tensor_only_pickle"


def _load_pt(path: Path):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # weights_only refuses a global; read the tensors without it
        return torch.load(path, map_location="cpu", weights_only=False,
                          pickle_module=_TensorOnlyPickle)


def load_state_dict(path: Union[str, Path], _format: Optional[str] = None) -> State:
    path = Path(path)
    if _checked_format(path, _format) == "pt":
        state = _load_pt(path)
        if not isinstance(state, dict):
            raise ValueError(f"{path}: the pickle holds a {type(state).__name__}, not a "
                             "state dict")
        state = state.get("state_dict", state)
        return {k: v.detach() for k, v in state.items() if isinstance(v, torch.Tensor)}

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
