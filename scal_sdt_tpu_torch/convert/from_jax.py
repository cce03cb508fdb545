"""Carry flat parameter dicts between the JAX package and the port.

Both packages key parameters by diffusers names in torch layouts (Linear
``(out, in)``, Conv ``(out, in, kh, kw)``), so no remapping is needed: only
the array type changes. JAX hands bf16 arrays over as numpy arrays of the
``ml_dtypes`` bfloat16 type, which ``torch.from_numpy`` refuses; they are
reinterpreted bit for bit through int16.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device


def _array_to_tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable host copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_dict: Mapping[str, object], device="cuda",
                    dtype: Optional[torch.dtype] = None) -> dict[str, torch.Tensor]:
    """Numpy (or JAX) arrays -> torch tensors on ``device``.

    ``dtype`` casts floating tensors (None keeps each array's own type)."""
    dev = resolve_device(device)
    out = {}
    for k, v in np_dict.items():
        t = _array_to_tensor(v)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(dev)
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Torch tensors -> numpy arrays on the host. bf16 widens exactly to
    float32 (numpy has no bfloat16 of its own)."""
    out = {}
    for k, v in params.items():
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[k] = t.numpy()
    return out
