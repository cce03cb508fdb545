"""Exponential moving average of the trainable UNet masters (port of
``scal_sdt_tpu/training/ema.py`` ``ema_init`` / ``ema_update`` /
``ema_state_dict``).

The shadow is a copy of each trainable ``unet.*`` master in the EMA dtype
(``ema.dtype``: fp32 by default, or bf16), updated after every train step,
micro-steps of gradient accumulation included, as
``s - (1 - decay_t) * (s - p)`` with ``decay_t = min(decay, (1 + n) / (10 +
n))`` at the new update count n. ``decay_t`` and ``1 - decay_t`` are fp32
values reckoned on the host as XLA computes them; the update runs in fp32
and a bf16 shadow is stored by stochastic rounding (``ops/sr.py``
``ema_dither``). One launch per step on a card over every shadow of a
(shadow dtype, master dtype) pair (``ops/ema_fused.py``), its plain
version on the CPU.

Checkpoints store the shadow under ``unet_ema.shadow_params.*`` with
``ema_decay`` and ``ema_num_updates`` in the metadata, as the JAX package
does (``training/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.ema_fused import build_ema_table, ema_fused_apply

Params = dict[str, torch.Tensor]


@dataclasses.dataclass
class EMAState:
    shadow: Params
    num_updates: int
    decay: float      # an fp32 value
    # (shadow dtype, master dtype) -> the EMA leaf table of its keys, built on first use
    tables: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)


def ema_init(params: Params, decay: float, dtype: torch.dtype = torch.float32) -> EMAState:
    """A shadow copy of ``params`` in ``dtype`` (never an alias of a master)."""
    return EMAState(shadow={k: v.detach().to(dtype, copy=True) for k, v in params.items()},
                    num_updates=0, decay=float(np.float32(decay)))


def one_minus_decay(decay: float, num_updates: int) -> float:
    """``1 - min(decay, (1 + n) / (10 + n))`` in fp32 at update count ``n``."""
    n = np.float32(num_updates)
    decay_t = min(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))
    return float(np.float32(1.0) - decay_t)


@torch.no_grad()
def ema_update(state: EMAState, params: Params, step: int) -> EMAState:
    """One EMA step over the masters ``params`` at train step ``step`` (the
    step before its increment, the dither's seed); the shadows change in
    place, in one launch over every shadow key of each (shadow dtype, master
    dtype) pair: one launch, as the port keeps one shadow dtype and one
    master dtype."""
    n = state.num_updates + 1
    one_minus = one_minus_decay(state.decay, n)
    pairs: dict[tuple[torch.dtype, torch.dtype], list[str]] = {}
    for k in sorted(state.shadow):
        pairs.setdefault((state.shadow[k].dtype, params[k].dtype), []).append(k)
    for pair, keys in pairs.items():
        shadows, masters = [state.shadow[k] for k in keys], [params[k] for k in keys]
        table = state.tables.get(pair)
        if table is None or not table.holds(keys, shadows, masters):
            table = state.tables[pair] = build_ema_table(keys, shadows, masters)
        ema_fused_apply(table, one_minus, step)
    return dataclasses.replace(state, num_updates=n)


def ema_state_dict(state: EMAState) -> dict:
    """The reference's EMA state-dict layout: decay, num_updates, shadow_params."""
    return {"decay": state.decay, "num_updates": int(state.num_updates),
            "shadow_params": dict(state.shadow)}


def ema_from_state_dict(d: dict, device=None) -> EMAState:
    """An EMAState of the reference's layout; the shadows are copies (torch
    tensors, or numpy arrays of a dtype torch has) on ``device``."""
    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.detach().to(device, copy=True)
        return torch.from_numpy(np.array(v)).to(device)

    return EMAState(shadow={k: copy(v) for k, v in d["shadow_params"].items()},
                    num_updates=int(d.get("num_updates", 0)),
                    decay=float(np.float32(d["decay"])))
