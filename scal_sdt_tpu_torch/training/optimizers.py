"""Per-group optimizers over the trainable flat dict (port of
``scal_sdt_tpu/training/optimizers.py``): every name the JAX package accepts,
each group running the JAX chain in the same order and precision.

* AdamW: ``scale_by_adam_low_memory`` (fp32 moment math, configured moment
  storage, bf16 nu stored by stochastic rounding with the counter-hash
  dither), then decoupled weight decay as ``optax.add_decayed_weights``
  computes it (``wd * p`` in the param dtype, added to the fp32 update),
  then the lr schedule (``-lr * schedule(count)``). Without a moment dtype
  and with fp32 masters (the default config) the JAX chain is plain
  ``optax.scale_by_adam``, and the kernel runs in its ``xla`` mode: the
  rounding of that chain, and of the decay, as XLA fuses them in the JAX
  trainer's jitted step (``1-b1``, ``1-b2`` and ``g^2`` in the gradient's
  dtype, fmas where XLA contracts). This is not ``torch.optim.AdamW``, whose
  storage and rounding differ.
* Adam: AdamW's chain without the decay, whatever ``weight_decay`` says (the
  JAX chain has none), on the same kernel with the decay switched off.
* AdamW8bit: ``Adam8bit`` (``training/quantized.py``; the update in the
  gradient's dtype), then the decay in the update's dtype
  (``u + (wd * p).to(u.dtype)``), then the schedule with the step size cast
  to the update's dtype first, as optax's ``scale_by_schedule`` does. Its
  int8 leaves are those of the JAX trainer's packed run (``pack_spec``).
* Lion, Adafactor, Prodigy, D-Adapt AdamW and SGD: plain PyTorch chains
  (``training/families.py``). Prodigy and D-Adapt carry the lr and the
  schedule inside; Adafactor sees the JAX trainer's slabs (``pack_spec``).

Two ways to run a group:

* ``update`` returns the updates (optax's ``tx.update``); for the Adam
  families one kernel launch per leaf on the card (``ops/adam_bf16_fused.py``,
  ``ops/adam8_fused.py``); ``training/step.py``'s ``apply_updates`` then
  applies them;
* ``update_and_apply`` (the train step's) runs the chain and the master
  apply; the masters are updated in place. The Adam families run Adam,
  decay, schedule and the master apply of every leaf in one launch per
  kernel over the group's leaf table, built on first use and cached on the
  transform while the state holds the same tensors; the other families run
  ``update`` and then the apply. Its numbers are those of ``update`` then
  ``apply_updates``, bit for bit.

On the CPU both run the kernels' plain versions. The state is host-side
Python (one step count per group), the tensors per key, and for Prodigy and
D-Adapt their 0-dim scalars on the device, all of which change in place.

``GradientAccumulation`` (``trainer.accumulate_grad_batches`` > 1) wraps the
groups: an fp32 running sum of the micro-steps' gradients, and every k-th
micro-step the groups' update of their mean.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..conf import Config
from ..ops.adam_bf16_fused import (adam_bf16_fused_apply, adam_bf16_fused_update,
                                   build_adam_table, decay_and_schedule_reference)
from ..ops.sr import NU_SALT, leaf_salt
from .families import SGD, Adafactor, DAdaptAdamW, GroupOwners, Lion, Prodigy, step_size_of
from .packing import PackSpec
from .quantized import Adam8bit, Adam8bitState, bias_corrections
from .schedules import Schedule, build_lr_schedule

_ADAMW_NAMES = {"adamw", "torch.optim.adamw", "bitsandbytes.optim.adamw"}
_ADAMW_8BIT_NAMES = {"adamw8bit", "bitsandbytes.optim.adamw8bit"}
_ADAM_NAMES = {"adam", "torch.optim.adam"}
_SGD_NAMES = {"sgd", "torch.optim.sgd"}
_LION_NAMES = {"lion", "lion_pytorch.lion", "bitsandbytes.optim.lion"}
_ADAFACTOR_NAMES = {"adafactor", "transformers.optimization.adafactor"}
_PRODIGY_NAMES = {"prodigy", "prodigyopt.prodigy"}
_DADAPT_NAMES = {"dadaptadam", "dadaptation.dadaptadam", "dadaptation.dadaptadamw",
                 "dadaptation.experimental.dadaptadamw"}
OPTIMIZER_NAMES = (_ADAMW_NAMES | _ADAMW_8BIT_NAMES | _ADAM_NAMES | _SGD_NAMES | _LION_NAMES
                   | _ADAFACTOR_NAMES | _PRODIGY_NAMES | _DADAPT_NAMES)
_DTYPE_MAP = {"fp16": torch.float16, "fp32": torch.float32, "bf16": torch.bfloat16}

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


def _lion_mu_dtype(moment_dtype: Optional[str], reduced_masters: bool
                   ) -> Optional[torch.dtype]:
    """Lion's momentum dtype as the JAX package picks it: bf16 for
    ``bf16`` / ``mixed``, fp32 under reduced masters otherwise, else None
    (the param dtype; ``fp16`` lands here too)."""
    md = str(moment_dtype) if moment_dtype else None
    if md in ("bf16", "mixed"):
        return torch.bfloat16
    return torch.float32 if reduced_masters else None


@dataclasses.dataclass
class AdamState:
    count: int        # updates applied so far (optax's count)
    mu: Tensors
    nu: Tensors


def _cache_field() -> dict:
    return dataclasses.field(default_factory=dict, compare=False, repr=False, hash=False)


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
    _tables: dict = _cache_field()   # the group's leaf table, built on first use

    @property
    def xla(self) -> bool:
        """Plain ``optax.scale_by_adam`` in JAX (no moment dtypes): the
        kernel's ``xla`` rounding."""
        return self.moment_dtypes is None

    def init(self, params: Tensors) -> AdamState:
        def zeros(i):
            return {k: torch.zeros_like(p, dtype=self.moment_dtypes[i] if self.moment_dtypes
                                        else p.dtype) for k, p in params.items()}

        return AdamState(count=0, mu=zeros(0), nu=zeros(1))

    def update(self, grads: Tensors, state: AdamState, params: Tensors
               ) -> tuple[Tensors, AdamState]:
        count = state.count + 1
        bc = bias_corrections(self.b1, self.b2, count)
        step_size = step_size_of(self.lr, self.schedule, state.count)
        updates = {}
        for k in sorted(grads):
            nu = state.nu[k]
            sr = ({"sr_step": count, "sr_salt": leaf_salt(k, NU_SALT)}
                  if nu.dtype.itemsize < 4 else {})
            out = adam_bf16_fused_update(
                grads[k].contiguous(), state.mu[k], nu, bc, b1=self.b1, b2=self.b2,
                eps=self.eps, out_dtype=torch.float32, recip_bc=False, xla=self.xla, **sr)[0]
            updates[k] = decay_and_schedule_reference(out, params[k], self.weight_decay,
                                                      step_size, fma_decay=self.xla)
        return updates, AdamState(count=count, mu=state.mu, nu=state.nu)

    def update_and_apply(self, grads: Tensors, state: AdamState, params: Tensors,
                         step: int) -> AdamState:
        """``update`` then the master apply at train step ``step``, the
        masters in ``params`` updated in place: one launch on the card."""
        keys = sorted(params)
        ps, mu, nu = ([d[k] for k in keys] for d in (params, state.mu, state.nu))
        table = self._tables.get("adam")
        if table is None or not table.holds(keys, ps, mu, nu):
            table = self._tables["adam"] = build_adam_table(keys, ps, mu, nu)
        count = state.count + 1
        adam_bf16_fused_apply(
            table, [grads[k] for k in keys], bias_corrections(self.b1, self.b2, count),
            b1=self.b1, b2=self.b2, eps=self.eps, recip_bc=False, count=count, step=step,
            weight_decay=self.weight_decay,
            step_size=step_size_of(self.lr, self.schedule, state.count),
            update_dtype=torch.float32, xla=self.xla)
        return AdamState(count=count, mu=state.mu, nu=state.nu)


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
    pack_spec: Optional[PackSpec] = None   # the JAX run's packing: which leaves are int8
    _tables: dict = _cache_field()   # the group's two leaf tables, built on first use

    def _adam(self) -> Adam8bit:
        return Adam8bit(b1=self.b1, b2=self.b2, eps=self.eps)

    def init(self, params: Tensors) -> Adam8bitState:
        return self._adam().init(params, self.pack_spec)

    def update(self, grads: Tensors, state: Adam8bitState, params: Tensors
               ) -> tuple[Tensors, Adam8bitState]:
        step_size = step_size_of(self.lr, self.schedule, state.count)
        updates, state = self._adam().update(grads, state)
        for k, u in updates.items():
            updates[k] = decay_and_schedule_reference(u, params[k], self.weight_decay,
                                                      step_size)
        return updates, state

    def update_and_apply(self, grads: Tensors, state: Adam8bitState, params: Tensors,
                         step: int) -> Adam8bitState:
        """``update`` then the master apply at train step ``step``, the
        masters in ``params`` updated in place: on the card one launch for
        the int8 leaves and one for the fp32-moment leaves."""
        return self._adam().update_and_apply(
            grads, state, params, step=step, weight_decay=self.weight_decay,
            step_size=step_size_of(self.lr, self.schedule, state.count), tables=self._tables)


@dataclasses.dataclass(frozen=True)
class MultiTransform:
    """optax.multi_transform over group labels: key -> label -> group chain."""
    transforms: dict[str, object]
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

    def update_and_apply(self, grads: Tensors, state: dict[str, object], params: Tensors,
                         step: int) -> dict[str, object]:
        """Each group's ``update_and_apply``: the masters in ``params`` are
        updated in place; returns the new state."""
        g_parts, p_parts = self._split(grads), self._split(params)
        return {label: tx.update_and_apply(g_parts[label], state[label], p_parts[label], step)
                for label, tx in self.transforms.items()}


@dataclasses.dataclass
class AccumulationState:
    mini: int         # micro-steps accumulated since the last emit
    inner: dict       # the groups' state (MultiTransform's)
    acc: Tensors      # fp32 running sum of the gradients, per key


@dataclasses.dataclass(frozen=True)
class GradientAccumulation:
    """Port of the JAX package's ``gradient_accumulation``: every micro-step
    adds its gradients to an fp32 running sum; every ``k``-th one (the emit)
    hands their mean to ``inner`` and clears the sum. The other micro-steps
    leave the masters, the moments and ``inner``'s counts alone, so the
    schedule and the bias corrections count optimizer steps. The mean
    divides by ``k`` as a 0-dim fp32 tensor on the sum's device: a true
    division on the CPU and on a card alike."""
    inner: MultiTransform
    k: int

    def init(self, params: Tensors) -> AccumulationState:
        return AccumulationState(0, self.inner.init(params),
                                 {k: torch.zeros_like(p, dtype=torch.float32)
                                  for k, p in params.items()})

    def _accumulate(self, grads: Tensors, state: AccumulationState) -> bool:
        """Adds ``grads`` to the sum in place; whether this micro-step emits."""
        for key, g in grads.items():
            state.acc[key].add_(g)
        return state.mini == self.k - 1

    def _mean(self, acc: Tensors) -> None:
        for a in acc.values():
            a.div_(a.new_full((), self.k))

    def update_and_apply(self, grads: Tensors, state: AccumulationState, params: Tensors,
                         step: int) -> AccumulationState:
        """Accumulates; at an emit, the groups' ``update_and_apply`` of the
        mean (fp32 gradients) at train step ``step``, the global micro-step,
        which seeds the master SR as the JAX step's apply does. No optimizer
        launch on the other micro-steps."""
        mini = (state.mini + 1) % self.k
        if not self._accumulate(grads, state):
            return AccumulationState(mini, state.inner, state.acc)
        self._mean(state.acc)
        inner = self.inner.update_and_apply(state.acc, state.inner, params, step)
        for a in state.acc.values():
            a.zero_()
        return AccumulationState(mini, inner, state.acc)


def _group_transform(name: str, lr: float, betas: tuple[float, float], eps: float,
                     weight_decay: float, schedule: Schedule, moment_dtype: Optional[str],
                     extra: dict, reduced_masters: bool, pack_spec: Optional[PackSpec],
                     owners: Optional[GroupOwners] = None):
    """One group's chain, as the JAX package's ``_group_transform`` builds it
    (``owners``: the group-wide sums of Prodigy and D-Adapt over sharded
    masters)."""
    b1, b2 = float(betas[0]), float(betas[1])
    if name in _ADAMW_NAMES or name in _ADAM_NAMES:
        # Adam: no decay at all in the JAX chain, whatever weight_decay says
        return AdamW(lr=lr, b1=b1, b2=b2, eps=eps,
                     weight_decay=weight_decay if name in _ADAMW_NAMES else 0.0,
                     schedule=schedule,
                     moment_dtypes=_adam_moment_dtype(moment_dtype, reduced_masters))
    if name in _ADAMW_8BIT_NAMES:
        # stores its moments int8 whatever moment_dtype says, as in JAX; under
        # the JAX trainer's packing, int8 where JAX's packed run has it
        return AdamW8bit(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                         schedule=schedule, pack_spec=pack_spec)
    if name in _LION_NAMES:
        # the config's betas, (0.9, 0.999) by default, as the JAX package passes them
        return Lion(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay, schedule=schedule,
                    mu_dtype=_lion_mu_dtype(moment_dtype, reduced_masters))
    if name in _ADAFACTOR_NAMES:
        return Adafactor(lr=lr, decay_rate=b2, weight_decay=weight_decay, schedule=schedule,
                         pack_spec=pack_spec)
    if name in _PRODIGY_NAMES:
        beta3 = extra.get("beta3")
        return Prodigy(lr=lr, schedule=schedule, b1=b1, b2=b2,
                       beta3=float(beta3) if beta3 is not None else None, eps=eps,
                       estim_lr0=float(extra.get("d0", 1e-6)),
                       estim_lr_coef=float(extra.get("d_coef", 1.0)),
                       weight_decay=weight_decay,
                       safeguard_warmup=bool(extra.get("safeguard_warmup", False)),
                       owners=owners)
    if name in _DADAPT_NAMES:
        return DAdaptAdamW(lr=lr, schedule=schedule, b1=b1, b2=b2, eps=eps,
                           estim_lr0=float(extra.get("d0", 1e-6)), weight_decay=weight_decay,
                           owners=owners)
    if name in _SGD_NAMES:
        return SGD(lr=lr, weight_decay=weight_decay, schedule=schedule)
    raise ValueError(f"Unknown optimizer: {name}")


def build_optimizer(config: Config, labels: dict[str, str],
                    group_overrides: dict[str, dict], steps_per_epoch: int,
                    num_processes: int, pack_spec: Optional[PackSpec] = None,
                    owners: Optional[GroupOwners] = None
                    ) -> tuple[Union[MultiTransform, GradientAccumulation],
                               Callable[[int], float]]:
    """(tx, lr_fn) for the trainable flat dict; lr_fn(step) is the first
    group's ``lr * schedule(step)``, for logging (for every family, Prodigy
    and D-Adapt too). With ``trainer.accumulate_grad_batches`` k > 1 the
    groups run under ``GradientAccumulation`` and lr_fn reports the
    schedule at optimizer step ``step // k``. ``pack_spec``: the slabs and
    stacks the JAX trainer would pack (``training/packing.py``), which
    Adafactor treats as blocks and which decide AdamW8bit's int8 leaves as
    in JAX's packed run; the other families ignore it. ``owners``: the masters are
    split over owners and ``labels`` holds this rank's (Prodigy and D-Adapt
    add their group-wide sums over the owners)."""
    name = str(config.optimizer.name).lower()
    if name not in OPTIMIZER_NAMES:
        raise ValueError(f"Unknown optimizer: {name}")
    base = _base_hparams(config)
    coeff = lr_scale_coeff(config, num_processes)
    reduced_masters = str(config.optimizer.get("master_dtype", "fp32")) in ("bf16", "bfloat16")
    extra = {k: v for k, v in base.items() if k not in ("lr", "betas", "eps", "weight_decay")}

    transforms: dict[str, object] = {}
    first_lr_fn: Optional[Callable[[int], float]] = None
    for label in sorted(set(labels.values()) | set(group_overrides)):
        over = dict(group_overrides.get(label, {}))
        lr = float(over.get("lr", base["lr"])) * coeff
        wd = float(over.get("weight_decay", base["weight_decay"])) / coeff
        schedule = build_lr_schedule(config.optimizer, lr, steps_per_epoch)
        transforms[label] = _group_transform(
            name, lr, base["betas"], float(base["eps"]), wd, schedule,
            config.optimizer.get("moment_dtype"), extra, reduced_masters, pack_spec, owners)
        if first_lr_fn is None:
            def first_lr_fn(step, _lr=lr, _s=schedule):
                return float(np.float32(_lr) * np.float32(_s(step)))

    tx: Union[MultiTransform, GradientAccumulation] = MultiTransform(transforms, dict(labels))
    lr_fn = first_lr_fn or (lambda step: 0.0)
    accumulate = int(config.trainer.get("accumulate_grad_batches", 1) or 1)
    if accumulate > 1:
        tx = GradientAccumulation(tx, accumulate)

        def lr_fn(step, _f=lr_fn, _k=accumulate):
            return _f(step // _k)

    return tx, lr_fn
