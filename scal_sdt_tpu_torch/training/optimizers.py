"""Per-group AdamW over the trainable flat dict (port of the AdamW branch of
``scal_sdt_tpu/training/optimizers.py``).

Each group runs the JAX chain in the same order and precision:
``scale_by_adam_low_memory`` (fp32 moment math, configured moment storage,
bf16 nu stored by stochastic rounding with the counter-hash dither), then
decoupled weight decay as ``optax.add_decayed_weights`` computes it
(``wd * p`` in the param dtype, added to the fp32 update), then the lr
schedule (``-lr * schedule(count)``). This is not ``torch.optim.AdamW``,
whose storage and rounding differ.

The state is host-side Python: one step count per group and the moment
tensors per key. Elementwise math runs as ``torch._foreach_*`` over chunks
of leaves, which bounds both the kernel launches and the fp32 temporaries.
Other optimizer families and gradient accumulation are later slices.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..conf import Config
from .ema import stochastic_round_bf16_cheap
from .schedules import Schedule, build_lr_schedule

_ADAMW_NAMES = {"adamw", "torch.optim.adamw", "bitsandbytes.optim.adamw"}
_DTYPE_MAP = {"fp16": torch.float16, "fp32": torch.float32, "bf16": torch.bfloat16}
# Elements per chunk of the foreach update (bounds the fp32 temporaries).
_CHUNK_ELEMS = 1 << 26
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


def _chunks(keys: list[str], tensors: Tensors) -> Iterator[list[str]]:
    chunk, size = [], 0
    for k in keys:
        chunk.append(k)
        size += tensors[k].numel()
        if size >= _CHUNK_ELEMS:
            yield chunk
            chunk, size = [], 0
    if chunk:
        yield chunk


@dataclasses.dataclass(frozen=True)
class AdamW:
    """One param group's transformation chain."""
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
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** c)
        # optax's scale_by_schedule sees the count before this update
        step_size = float(np.float32(-self.lr) * np.float32(self.schedule(state.count)))
        b1, b2 = self.b1, self.b2
        updates, mu_new, nu_new = {}, {}, {}
        for keys in _chunks(sorted(grads), grads):
            g32 = [grads[k].float() for k in keys]
            mu32 = torch._foreach_add(torch._foreach_mul([state.mu[k].float() for k in keys], b1),
                                      torch._foreach_mul(g32, 1.0 - b1))
            nu32 = torch._foreach_add(torch._foreach_mul([state.nu[k].float() for k in keys], b2),
                                      torch._foreach_mul(torch._foreach_mul(g32, g32), 1.0 - b2))
            del g32
            den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu32, bc2)), self.eps)
            out = torch._foreach_div(torch._foreach_div(mu32, bc1), den)
            del den
            for k, o, m, n in zip(keys, out, mu32, nu32):
                mu_new[k] = m.to(state.mu[k].dtype)
                nu_dt = state.nu[k].dtype
                if nu_dt.itemsize < 4:
                    salt = zlib.crc32(k.encode()) ^ _NU_SALT
                    nu_new[k] = stochastic_round_bf16_cheap(n, count, salt).to(nu_dt)
                else:
                    nu_new[k] = n.to(nu_dt)
                if self.weight_decay:
                    # JAX rounds the python scalar to p's dtype, then wd * p in it
                    p = params[k]
                    o = o + p * p.new_full((), self.weight_decay)
                updates[k] = o.mul_(step_size)
        return updates, AdamState(count=count, mu=mu_new, nu=nu_new)


@dataclasses.dataclass(frozen=True)
class MultiTransform:
    """optax.multi_transform over group labels: key -> label -> AdamW."""
    transforms: dict[str, AdamW]
    labels: dict[str, str]

    def _split(self, tree: Tensors) -> dict[str, Tensors]:
        out: dict[str, Tensors] = {label: {} for label in self.transforms}
        for k, v in tree.items():
            out[self.labels[k]][k] = v
        return out

    def init(self, params: Tensors) -> dict[str, AdamState]:
        parts = self._split(params)
        return {label: tx.init(parts[label]) for label, tx in self.transforms.items()}

    def update(self, grads: Tensors, state: dict[str, AdamState], params: Tensors
               ) -> tuple[Tensors, dict[str, AdamState]]:
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
    if name not in _ADAMW_NAMES:
        raise NotImplementedError(f"optimizer {name!r}: the port runs AdamW only so far")
    accumulate = int(config.trainer.get("accumulate_grad_batches", 1) or 1)
    if accumulate > 1:
        raise NotImplementedError("accumulate_grad_batches > 1: not ported yet")
    base = _base_hparams(config)
    coeff = lr_scale_coeff(config, num_processes)
    reduced_masters = str(config.optimizer.get("master_dtype", "fp32")) in ("bf16", "bfloat16")
    moment_dtypes = _adam_moment_dtype(config.optimizer.get("moment_dtype"), reduced_masters)

    transforms: dict[str, AdamW] = {}
    first_lr_fn: Optional[Callable[[int], float]] = None
    for label in sorted(set(labels.values()) | set(group_overrides)):
        over = dict(group_overrides.get(label, {}))
        lr = float(over.get("lr", base["lr"])) * coeff
        wd = float(over.get("weight_decay", base["weight_decay"])) / coeff
        schedule = build_lr_schedule(config.optimizer, lr, steps_per_epoch)
        transforms[label] = AdamW(lr=lr, b1=base["betas"][0], b2=base["betas"][1],
                                  eps=float(base["eps"]), weight_decay=wd, schedule=schedule,
                                  moment_dtypes=moment_dtypes)
        if first_lr_fn is None:
            def first_lr_fn(step, _lr=lr, _s=schedule):
                return float(np.float32(_lr) * np.float32(_s(step)))

    return MultiTransform(transforms, dict(labels)), (first_lr_fn or (lambda step: 0.0))
