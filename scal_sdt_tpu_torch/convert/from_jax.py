"""Carry flat parameter dicts and optimizer states between the JAX package
and the port.

Both packages key parameters by diffusers names in torch layouts (Linear
``(out, in)``, Conv ``(out, in, kh, kw)``), so no remapping is needed: only
the array type changes. JAX hands bf16 arrays over as numpy arrays of the
``ml_dtypes`` bfloat16 type, which ``torch.from_numpy`` refuses; they are
reinterpreted bit for bit through int16.

An optimizer state is found by its field names, so no optax type is needed:
a ``ScaleByAdamState`` (count, mu, nu) becomes an ``AdamState`` and a
``ScaleByAdam8bitState`` (count, mu_q, mu_s, nu_q, nu_s) an
``Adam8bitState``, with the same shapes and dtypes.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..training.optimizers import AdamState
from ..training.quantized import Adam8bitState

_ADAM_FIELDS = ("count", "mu", "nu")
_ADAM8_FIELDS = ("count", "mu_q", "mu_s", "nu_q", "nu_s")


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


def _find_state(node, fields):
    """The first named tuple with ``fields`` inside a (chain) state."""
    if tuple(getattr(node, "_fields", ())) == fields:
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_state(child, fields)
            if found is not None:
                return found
    return None


def _moments(d: Mapping[str, object], dev: torch.device) -> dict[str, torch.Tensor]:
    # multi_transform masks other groups' keys with shapeless placeholders
    return {k: _array_to_tensor(v).to(dev) for k, v in d.items() if hasattr(v, "shape")}


def group_state_from_jax(state, device="cuda"):
    """One group's JAX Adam state (or the chain state holding it) ->
    ``AdamState`` or ``Adam8bitState`` on ``device``."""
    dev = resolve_device(device)
    for fields, cls in ((_ADAM8_FIELDS, Adam8bitState), (_ADAM_FIELDS, AdamState)):
        found = _find_state(state, fields)
        if found is not None:
            count = int(np.asarray(found.count))
            return cls(count, *(_moments(getattr(found, f), dev) for f in fields[1:]))
    raise ValueError("no ScaleByAdamState or ScaleByAdam8bitState in the given state")


def opt_state_from_jax(state, device="cuda") -> dict[str, object]:
    """A JAX ``optax.multi_transform`` state -> the port's ``MultiTransform``
    state: {group label: AdamState | Adam8bitState}."""
    return {label: group_state_from_jax(s, device) for label, s in state.inner_states.items()}
