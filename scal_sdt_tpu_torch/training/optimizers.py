"""Per-group optimizers over the trainable flat dict (port of the AdamW and
AdamW8bit branches of ``scal_sdt_tpu/training/optimizers.py``).

Each group runs the JAX chain in the same order and precision.

* AdamW: ``scale_by_adam_low_memory`` (fp32 moment math, configured moment
  storage, bf16 nu stored by stochastic rounding with the counter-hash
  dither), then decoupled weight decay as ``optax.add_decayed_weights``
  computes it (``wd * p`` in the param dtype, added to the fp32 update),
  then the lr schedule (``-lr * schedule(count)``). This is not
  ``torch.optim.AdamW``, whose storage and rounding differ.
* AdamW8bit: ``Adam8bit`` (``training/quantized.py``; the update in the
  gradient's dtype), then the decay in the update's dtype
  (``u + (wd * p).to(u.dtype)``), then the schedule with the step size cast
  to the update's dtype first, as optax's ``scale_by_schedule`` does.

The Adam step of each leaf is one launch of a fused kernel on the card
(``ops/adam_bf16_fused.py``, ``ops/adam8_fused.py``) and the kernel's plain
version on the CPU. The state is host-side Python (one step count per group)
plus the moment tensors per key, which the update changes in place. Other
optimizer families and gradient accumulation are later slices.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..conf import Config
from ..ops.adam_bf16_fused import adam_bf16_fused_update
from .quantized import Adam8bit, Adam8bitState
from .schedules import Schedule, build_lr_schedule

_ADAMW_NAMES = {"adamw", "torch.optim.adamw", "bitsandbytes.optim.adamw"}
_ADAMW_8BIT_NAMES = {"adamw8bit", "bitsandbytes.optim.adamw8bit"}
_DTYPE_MAP = {"fp16": torch.float16, "fp32": torch.float32, "bf16": torch.bfloat16}
_NU_SALT = 0xE3A0003

Tensors = dict[str, torch.Tensor]


def lr_scale_coeff(config: Config, num_processes: int) -> float:
    """Effective-batch LR scaling coefficient ('sqrt' or 'linear')."""
    lr_scale = config.optimizer.lr_scale
    if not lr_scale.get("enabled", False):
        return 1.0
    accumulate = int(config.trainer.get("accumulate_grad_batches", 1) or 1)
    coeff = accumulate * int(config.batch_size) * num_processes
    method = lr_scale.get("method", "sqrt")
    if method == "sqrt":
        return math.sqrt(coeff)
    if method == "linear":
        return float(coeff)
    raise ValueError(f"Unknown lr_scale.method: {method}")


def _base_hparams(config: Config) -> dict:
    p = dict(config.optimizer.get("params", {}))
    if "beta1" in p and "beta2" in p:
        p["betas"] = (float(p.pop("beta1")), float(p.pop("beta2")))
    p.setdefault("lr", 1e-3)
    p.setdefault("betas", (0.9, 0.999))
    p.setdefault("eps", 1e-8)
    p.setdefault("weight_decay", 1e-2)
    return p


def _adam_moment_dtype(moment_dtype: Optional[str], reduced_masters: bool
                       ) -> Optional[tuple[torch.dtype, torch.dtype]]:
    """Moment STORAGE dtypes (mu, nu), or None for the param dtype (plain
    ``optax.scale_by_adam``). Reduced masters always take explicit dtypes,
    fp32 by default: bf16 accumulation would let nu stop tracking."""
    md = str(moment_dtype) if moment_dtype else None
    if md == "mixed":
        return (torch.bfloat16, torch.float32)
    if md and md != "fp32":
        dt = _DTYPE_MAP[md]
        return (dt, dt)
    if reduced_masters:
        return (torch.float32, torch.float32)
    return None


@dataclasses.dataclass
class AdamState:
    count: int        # updates applied so far (optax's count)
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass(frozen=True)
class AdamW:
    """One param group's AdamW chain; the update comes out in fp32."""
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    schedule: Schedule
    moment_dtypes: Optional[tuple[torch.dtype, torch.dtype]] = None

    def init(self, params: Tensors) -> AdamState:
        def zeros(i):
            return {k: torch.zeros_like(p, dtype=self.moment_dtypes[i] if self.moment_dtypes
                                        else p.dtype) for k, p in params.items()}

        return AdamState(count=0, mu=zeros(0), nu=zeros(1))

    def update(self, grads: Tensors, state: AdamState, params: Tensors
               ) -> tuple[Tensors, AdamState]:
        count = state.count + 1
        c = np.float32(count)
        bc = (np.float32(1.0) - np.float32(self.b1) ** c,
              np.float32(1.0) - np.float32(self.b2) ** c)
        # optax's scale_by_schedule sees the count before this update
        step_size = float(np.float32(-self.lr) * np.float32(self.schedule(state.count)))
        updates = {}
        for k in sorted(grads):
            nu = state.nu[k]
            sr = ({"sr_step": count, "sr_salt": zlib.crc32(k.encode()) ^ _NU_SALT}
                  if nu.dtype.itemsize < 4 else {})
            out = adam_bf16_fused_update(
                grads[k].contiguous(), state.mu[k], nu, bc, b1=self.b1, b2=self.b2,
                eps=self.eps, out_dtype=torch.float32, recip_bc=False, **sr)[0]
            if self.weight_decay:
                # JAX rounds the python scalar to p's dtype, then wd * p in it
                p = params[k]
                out = out + p * p.new_full((), self.weight_decay)
            updates[k] = out.mul_(step_size)
        return updates, AdamState(count=count, mu=state.mu, nu=state.nu)


@dataclasses.dataclass(frozen=True)
class AdamW8bit:
    """One param group's AdamW8bit chain: Adam8bit, decay and schedule, all
    in the update's dtype (the gradient's: bf16 in mixed precision)."""
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    schedule: Schedule

    def _adam(self) -> Adam8bit:
        return Adam8bit(b1=self.b1, b2=self.b2, eps=self.eps)

    def init(self, params: Tensors) -> Adam8bitState:
        return self._adam().init(params)

    def update(self, grads: Tensors, state: Adam8bitState, params: Tensors
               ) -> tuple[Tensors, Adam8bitState]:
        step_size = float(np.float32(-self.lr) * np.float32(self.schedule(state.count)))
        updates, state = self._adam().update(grads, state)
        for k, u in updates.items():
            if self.weight_decay:
                p = params[k]
                u = u + (p * p.new_full((), self.weight_decay)).to(u.dtype)
            updates[k] = u * u.new_full((), step_size)
        return updates, state


@dataclasses.dataclass(frozen=True)
class MultiTransform:
    """optax.multi_transform over group labels: key -> label -> group chain."""
    transforms: dict[str, Union[AdamW, AdamW8bit]]
    labels: dict[str, str]

    def _split(self, tree: Tensors) -> dict[str, Tensors]:
        out: dict[str, Tensors] = {label: {} for label in self.transforms}
        for k, v in tree.items():
            out[self.labels[k]][k] = v
        return out

    def init(self, params: Tensors) -> dict[str, object]:
        parts = self._split(params)
        return {label: tx.init(parts[label]) for label, tx in self.transforms.items()}

    def update(self, grads: Tensors, state: dict[str, object], params: Tensors
               ) -> tuple[Tensors, dict[str, object]]:
        g_parts, p_parts = self._split(grads), self._split(params)
        updates: Tensors = {}
        new_state = {}
        for label, tx in self.transforms.items():
            u, new_state[label] = tx.update(g_parts[label], state[label], p_parts[label])
            updates.update(u)
        return updates, new_state


def build_optimizer(config: Config, labels: dict[str, str],
                    group_overrides: dict[str, dict], steps_per_epoch: int,
                    num_processes: int) -> tuple[MultiTransform, Callable[[int], float]]:
    """(tx, lr_fn) for the trainable flat dict; lr_fn(step) is the first
    group's lr, for logging."""
    name = str(config.optimizer.name).lower()
    if name not in _ADAMW_NAMES | _ADAMW_8BIT_NAMES:
        raise NotImplementedError(
            f"optimizer {name!r}: the port runs AdamW and AdamW8bit only so far")
    accumulate = int(config.trainer.get("accumulate_grad_batches", 1) or 1)
    if accumulate > 1:
        raise NotImplementedError("accumulate_grad_batches > 1: not ported yet")
    base = _base_hparams(config)
    coeff = lr_scale_coeff(config, num_processes)
    reduced_masters = str(config.optimizer.get("master_dtype", "fp32")) in ("bf16", "bfloat16")
    moment_dtypes = _adam_moment_dtype(config.optimizer.get("moment_dtype"), reduced_masters)

    transforms: dict[str, Union[AdamW, AdamW8bit]] = {}
    first_lr_fn: Optional[Callable[[int], float]] = None
    for label in sorted(set(labels.values()) | set(group_overrides)):
        over = dict(group_overrides.get(label, {}))
        lr = float(over.get("lr", base["lr"])) * coeff
        wd = float(over.get("weight_decay", base["weight_decay"])) / coeff
        schedule = build_lr_schedule(config.optimizer, lr, steps_per_epoch)
        hp = dict(lr=lr, b1=base["betas"][0], b2=base["betas"][1], eps=float(base["eps"]),
                  weight_decay=wd, schedule=schedule)
        # AdamW8bit stores its moments int8 whatever moment_dtype says, as in JAX
        transforms[label] = (AdamW8bit(**hp) if name in _ADAMW_8BIT_NAMES
                             else AdamW(**hp, moment_dtypes=moment_dtypes))
        if first_lr_fn is None:
            def first_lr_fn(step, _lr=lr, _s=schedule):
                return float(np.float32(_lr) * np.float32(_s(step)))

    return MultiTransform(transforms, dict(labels)), (first_lr_fn or (lambda step: 0.0))
