"""Carry flat parameter dicts and optimizer states between the JAX package
and the port.

Both packages key parameters by diffusers names in torch layouts (Linear
``(out, in)``, Conv ``(out, in, kh, kw)``), so no remapping is needed: only
the array type changes. JAX hands bf16 arrays over as numpy arrays of the
``ml_dtypes`` bfloat16 type, which ``torch.from_numpy`` refuses; they are
reinterpreted bit for bit through int16. The same holds for every tree of
the JAX package's models: the UNet's, the text towers', SD3's MMDiT (its
fp32 sincos ``pos_embed`` buffer stays fp32 beside bf16 weights) and T5's.

An optimizer state is found by its field names, so no optax type is needed,
and the same code reads a live optax state (named tuples) and the tree that
``utils/msgpack.py`` reads from a ``.trainstate`` (maps keyed by field name,
tuples as maps keyed "0", "1", ...). Each family's optax state becomes the
port's, with the same shapes and dtypes:

* ``ScaleByAdamState`` (count, mu, nu) -> ``AdamState`` (AdamW, Adam);
* ``ScaleByAdam8bitState`` (count, mu_q, mu_s, nu_q, nu_s) -> ``Adam8bitState``;
* ``ScaleByLionState`` (count, mu) -> ``LionState``;
* ``FactoredState`` (count, v_row, v_col, v) -> ``FactoredState``, per block
  under JAX's keys (slab keys included: the port's Adafactor keeps them);
* ``ProdigyState`` / ``DAdaptAdamWState`` -> ``ProdigyState`` /
  ``DAdaptState``, their scalars as 0-dim tensors;
* SGD's chain, which holds only ``scale_by_schedule``'s count -> ``SGDState``;
* the accumulation wrapper's ``(mini, inner, acc)`` -> ``AccumulationState``.

A JAX run that packed its small leaves (``trainer.param_packing``) keeps
their moments in slabs and stacks; given the run's ``PackSpec``, they are
unpacked into the port's per-leaf moments (``training/packing.py``). That
holds for AdamW8bit too: a slab is 1-D, so its moments are plain fp32 and
unpack like any other family's (the zero-padded tail is dropped); an int8
stack's payloads and scales are split by rows, each member's rows bit for
bit in the port's per-leaf (rows, nb*256) / (rows, nb) layout, the
member's share of the stack's view (``training/quantized.py``
``stack_member_view``), which the port's AdamW8bit keeps under the same
packing.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..training.families import DAdaptState, FactoredState, LionState, ProdigyState, SGDState
from ..training.optimizers import AccumulationState, AdamState
from ..training.packing import PackSpec, unpack_host
from ..training.quantized import Adam8bitState, stack_member_view

_ADAM_FIELDS = ("count", "mu", "nu")
_ADAM8_FIELDS = ("count", "mu_q", "mu_s", "nu_q", "nu_s")
_LION_FIELDS = ("count", "mu")
_FACTORED_FIELDS = ("count", "v_row", "v_col", "v")
_PRODIGY_FIELDS = ("exp_avg", "exp_avg_sq", "grad_sum", "params0", "estim_lr",
                   "numerator_weighted", "count")
_DADAPT_FIELDS = ("exp_avg", "exp_avg_sq", "grad_sum", "estim_lr", "numerator_weighted",
                  "count")
_SCHEDULE_FIELDS = ("count",)


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


def _fields(node) -> tuple:
    """A named tuple's fields, or a state map's keys (flax writes a named
    tuple as a map keyed by field name)."""
    if hasattr(node, "_fields"):
        return tuple(node._fields)
    if isinstance(node, dict):
        return tuple(node)
    return ()


def _get(node, name: str):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _children(node) -> list:
    if isinstance(node, dict):
        return list(node.values())
    if isinstance(node, (tuple, list)):
        return list(node)
    return []


def _find_state(node, fields):
    """The first state with exactly ``fields`` inside a (chain) state."""
    if set(_fields(node)) == set(fields):
        return node
    for child in _children(node):
        found = _find_state(child, fields)
        if found is not None:
            return found
    return None


def _is_array(v) -> bool:
    # multi_transform masks other groups' keys: MaskedNode live, {} on disk
    return hasattr(v, "shape")


def _tensors(d: Mapping[str, object], dev: torch.device, spec: Optional[PackSpec] = None
             ) -> dict[str, torch.Tensor]:
    """A {key: array} field as tensors on ``dev``, unpacked by ``spec``."""
    arrays = {k: v if isinstance(v, torch.Tensor) else _array_to_tensor(v)
              for k, v in d.items() if _is_array(v)}
    if spec is not None:
        arrays = unpack_host(arrays, spec)
    return {k: v.contiguous().clone().to(dev) for k, v in arrays.items()}


def _adam8_tensors(payloads: Mapping[str, object], scales: Mapping[str, object],
                   dev: torch.device, spec: Optional[PackSpec]
                   ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """One moment of an AdamW8bit state (payloads: int8, or fp32 moments for
    the leaves without a scale; scales: fp32) as per-leaf tensors on
    ``dev``: fp32 slabs and stacks unpacked by ``spec``, int8 stacks split
    into their members' rows."""
    if spec is None or not spec.nontrivial:
        return _tensors(payloads, dev), _tensors(scales, dev)
    q = {k: v if isinstance(v, torch.Tensor) else _array_to_tensor(v)
         for k, v in payloads.items() if _is_array(v)}
    s = {k: v if isinstance(v, torch.Tensor) else _array_to_tensor(v)
         for k, v in scales.items() if _is_array(v)}
    int8_stacks = {k: (members, shape) for k, members, shape in spec.stacks if k in s}
    out_q = _tensors({k: v for k, v in q.items() if k not in int8_stacks}, dev, spec)
    out_s = _tensors({k: v for k, v in s.items() if k not in int8_stacks}, dev)
    for k, (members, shape) in int8_stacks.items():
        rows = stack_member_view(k, shape, len(members))[0]
        if q[k].shape[0] != rows * len(members) or s[k].shape[0] != rows * len(members):
            raise ValueError(f"{k}: payloads {tuple(q[k].shape)} and scales "
                             f"{tuple(s[k].shape)} are not {len(members)} x {rows} rows")
        for i, m in enumerate(members):
            out_q[m] = q[k][i * rows:(i + 1) * rows].contiguous().clone().to(dev)
            out_s[m] = s[k][i * rows:(i + 1) * rows].contiguous().clone().to(dev)
    return out_q, out_s


def _scalar(v, dev: torch.device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else _array_to_tensor(v)
    return t.reshape(()).clone().to(dev)


def _count(v) -> int:
    return int(v.item() if isinstance(v, torch.Tensor) else np.asarray(v))


def group_state_from_jax(state, device="cuda", pack_spec: Optional[PackSpec] = None):
    """One group's JAX optimizer state (or the chain state holding it) ->
    the port's state of that family on ``device``. ``pack_spec``: the JAX
    run's packing, whose slab and stack moments are unpacked per leaf
    (AdamW8bit's int8 stacks split by rows; Adafactor keeps its blocks)."""
    dev = resolve_device(device)
    found = _find_state(state, _ADAM8_FIELDS)
    if found is not None:
        mu_q, mu_s = _adam8_tensors(_get(found, "mu_q"), _get(found, "mu_s"), dev, pack_spec)
        nu_q, nu_s = _adam8_tensors(_get(found, "nu_q"), _get(found, "nu_s"), dev, pack_spec)
        return Adam8bitState(_count(_get(found, "count")), mu_q, mu_s, nu_q, nu_s)
    for fields, cls in ((_PRODIGY_FIELDS, ProdigyState), (_DADAPT_FIELDS, DAdaptState)):
        found = _find_state(state, fields)
        if found is not None:
            moments = [f for f in fields if f not in ("estim_lr", "numerator_weighted", "count")]
            return cls(_count(_get(found, "count")),
                       *(_tensors(_get(found, f), dev, pack_spec) for f in moments),
                       _scalar(_get(found, "estim_lr"), dev),
                       _scalar(_get(found, "numerator_weighted"), dev))
    found = _find_state(state, _FACTORED_FIELDS)
    if found is not None:
        return FactoredState(_count(_get(found, "count")),
                             *(_tensors(_get(found, f), dev) for f in _FACTORED_FIELDS[1:]))
    for fields, cls in ((_ADAM_FIELDS, AdamState), (_LION_FIELDS, LionState)):
        found = _find_state(state, fields)
        if found is not None:
            return cls(_count(_get(found, "count")),
                       *(_tensors(_get(found, f), dev, pack_spec) for f in fields[1:]))
    found = _find_state(state, _SCHEDULE_FIELDS)
    if found is not None:
        return SGDState(_count(_get(found, "count")))
    raise ValueError("no optimizer state of a known family in the given state")


def opt_state_from_jax(state, device="cuda", pack_spec: Optional[PackSpec] = None):
    """A JAX ``optax.multi_transform`` state (or the accumulation wrapper's
    ``(mini, inner, acc)`` around it) -> the port's ``MultiTransform`` state
    {group label: state} (or its ``AccumulationState``)."""
    if "inner_states" not in _fields(state):
        mini, inner, acc = (_children(state) if isinstance(state, (tuple, list))
                            else [state[str(i)] for i in range(3)])
        dev = resolve_device(device)
        return AccumulationState(_count(mini), opt_state_from_jax(inner, device, pack_spec),
                                 _tensors(acc, dev, pack_spec))
    return {label: group_state_from_jax(s, device, pack_spec)
            for label, s in _get(state, "inner_states").items()}
