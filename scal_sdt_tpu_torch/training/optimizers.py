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

Two ways to run the groups:

* ``update`` returns the updates (optax's ``tx.update``); for the Adam
  families one kernel launch per leaf on the card (``ops/adam_bf16_fused.py``,
  ``ops/adam8_fused.py``); ``training/step.py``'s ``apply_updates`` then
  applies them;
* ``MultiTransform.update_and_apply`` (the train step's) runs the chains and
  the master apply; the masters are updated in place. Adam, decay, schedule
  and the master apply of every AdamW leaf, and of every fp32-moment leaf of
  AdamW8bit, run in one ``adam_bf16_fused`` launch per step over all the
  groups whose launch scalars (betas, eps, rounding) and dtypes agree, each
  group with its own count, lr, decay and schedule (``MergedLaunch``); the
  launch's leaf table is built on first use and cached on the transform
  while the state holds the same tensors. AdamW8bit's int8 leaves launch
  ``adam8_fused`` once per group; the other families run ``update`` and
  then the apply. Its numbers are those of ``update`` then
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
import functools
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..conf import Config
from ..ops.adam_bf16_fused import (AdamTable, GroupStep, adam_bf16_fused_apply,
                                   adam_bf16_fused_update, build_adam_table,
                                   decay_and_schedule_reference)
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


@functools.lru_cache(maxsize=4096)
def _group_step(b1: float, b2: float, lr: float, schedule: Schedule, weight_decay: float,
                count: int) -> GroupStep:
    """An Adam group's scalars for the update after ``count`` updates; cached,
    as the groups of a LoRA run share a few lrs (and ``build_optimizer`` one
    schedule per lr)."""
    return GroupStep(bias_corrections(b1, b2, count + 1), count + 1, weight_decay,
                     step_size_of(lr, schedule, count))


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

    # -- the group's share of a merged launch (``MultiTransform.update_and_apply``)

    @property
    def launch(self) -> tuple:
        """What the merged launch fixes: (b1, b2, eps, recip_bc, update_dtype, xla)."""
        return (self.b1, self.b2, self.eps, False, torch.float32, self.xla)

    def group_step(self, count: int) -> GroupStep:
        """The group's scalars for the update after ``count`` updates."""
        return _group_step(self.b1, self.b2, self.lr, self.schedule, self.weight_decay, count)

    def merged_keys(self, state: AdamState, params: Tensors) -> list[str]:
        """The leaves of ``params`` that the merged launch updates: all."""
        return sorted(k for k in state.mu if k in params)

    def moments(self, state: AdamState) -> tuple[Tensors, Tensors]:
        return state.mu, state.nu

    def advance(self, grads: Tensors, state: AdamState, params: Tensors, step: int,
                group_step: GroupStep) -> AdamState:
        """The rest of the group's step beside the merged launch (nothing)
        and the state after it."""
        return AdamState(count=state.count + 1, mu=state.mu, nu=state.nu)


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
    _tables: dict = _cache_field()   # the group's int8 leaf table, built on first use

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

    # -- the group's share of a merged launch: its fp32-moment leaves
    # (reciprocal bias corrections, the update in the gradient's dtype)

    @property
    def launch(self) -> tuple:
        """What the merged launch fixes: (b1, b2, eps, recip_bc, update_dtype, xla)."""
        return (self.b1, self.b2, self.eps, True, None, False)

    def group_step(self, count: int) -> GroupStep:
        """The group's scalars for the update after ``count`` updates."""
        return _group_step(self.b1, self.b2, self.lr, self.schedule, self.weight_decay, count)

    def merged_keys(self, state: Adam8bitState, params: Tensors) -> list[str]:
        """The leaves of ``params`` that the merged launch updates: the
        fp32-moment ones."""
        return sorted(k for k in state.mu_q if k not in state.mu_s and k in params)

    def moments(self, state: Adam8bitState) -> tuple[Tensors, Tensors]:
        return state.mu_q, state.nu_q

    def advance(self, grads: Tensors, state: Adam8bitState, params: Tensors, step: int,
                group_step: GroupStep) -> Adam8bitState:
        """The rest of the group's step beside the merged launch: its int8
        leaves' update and master apply at train step ``step``, in one
        launch over the group's int8 table; and the state after both."""
        self._adam().update_and_apply_int8(grads, state, params, step=step,
                                           weight_decay=self.weight_decay,
                                           step_size=group_step.step_size, tables=self._tables)
        return dataclasses.replace(state, count=state.count + 1)


@dataclasses.dataclass(eq=False)
class MergedLaunch:
    """One ``adam_bf16_fused`` launch per step over the leaves of the Adam
    groups ``labels`` that it merges (``keys``, one list per group): AdamW's
    leaves, AdamW8bit's fp32-moment ones. The groups share ``launch`` (b1,
    b2, eps, recip_bc, update_dtype, xla) and their masters' and moments'
    dtypes; ``table`` is its leaf table, built on first use and kept while
    it holds the state's tensors."""
    labels: list[str]
    keys: list[list[str]]
    launch: tuple
    table: Optional[AdamTable] = None

    def tensors(self, transforms: dict, state: dict, params: Tensors
                ) -> tuple[list[torch.Tensor], list[torch.Tensor], list[torch.Tensor]]:
        """Its leaves' masters and moments in ``params`` and ``state``, one
        per leaf in the order of ``keys``."""
        ps, mu, nu = [], [], []
        for label, keys in zip(self.labels, self.keys):
            m, v = transforms[label].moments(state[label])
            ps += [params[k] for k in keys]
            mu += [m[k] for k in keys]
            nu += [v[k] for k in keys]
        return ps, mu, nu


@dataclasses.dataclass(frozen=True)
class MultiTransform:
    """optax.multi_transform over group labels: key -> label -> group chain."""
    transforms: dict[str, object]
    labels: dict[str, str]
    _merged: dict = _cache_field()   # the merged launches of one set of keys

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
        """Every group's update and master apply at train step ``step``, the
        masters in ``params`` updated in place; returns the new state. The
        Adam groups' leaves run in one ``adam_bf16_fused`` launch per
        ``MergedLaunch``, each group with its own scalars (``GroupStep``);
        the other families each run their own chain."""
        new_state: dict[str, object] = {}
        steps: dict[str, GroupStep] = {}
        for label, tx in self.transforms.items():
            if isinstance(tx, (AdamW, AdamW8bit)):
                steps[label] = st = tx.group_step(state[label].count)
                new_state[label] = tx.advance(grads, state[label], params, step, st)
        for merged in self.merged_launches(state, params):
            ps, mu, nu = merged.tensors(self.transforms, state, params)
            if merged.table is None or not merged.table.holds(ps, mu, nu):
                merged.table = build_adam_table(merged.keys, ps, mu, nu)
            b1, b2, eps, recip_bc, update_dtype, xla = merged.launch
            adam_bf16_fused_apply(merged.table, [grads[k] for ks in merged.keys for k in ks],
                                  [steps[label] for label in merged.labels], b1=b1, b2=b2,
                                  eps=eps, recip_bc=recip_bc, step=step,
                                  update_dtype=update_dtype, xla=xla)
        if len(new_state) < len(self.transforms):
            g_parts, p_parts = self._split(grads), self._split(params)
            for label, tx in self.transforms.items():
                if label not in new_state:
                    new_state[label] = tx.update_and_apply(g_parts[label], state[label],
                                                           p_parts[label], step)
        return {label: new_state[label] for label in self.transforms}

    def merged_launches(self, state: dict[str, object], params: Tensors) -> list[MergedLaunch]:
        """The merged launches over the Adam groups' leaves in ``params``:
        one per signature, the groups' fixed scalars (``launch``) and their
        masters' and moments' dtypes. Kept while ``params`` holds the same
        keys."""
        keys = tuple(params)
        if self._merged.get("keys") != keys:
            merged: dict[tuple, MergedLaunch] = {}
            for label, tx in self.transforms.items():
                if not isinstance(tx, (AdamW, AdamW8bit)):
                    continue
                leaves = tx.merged_keys(state[label], params)
                if not leaves:
                    continue
                mu, nu = tx.moments(state[label])
                k = leaves[0]
                signature = tx.launch + (params[k].dtype, mu[k].dtype, nu[k].dtype)
                launch = merged.setdefault(signature, MergedLaunch([], [], tx.launch))
                launch.labels.append(label)
                launch.keys.append(leaves)
            self._merged.update(keys=keys, launches=list(merged.values()))
        return self._merged["launches"]


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
    schedules: dict[float, Schedule] = {}   # one per lr: groups that share an lr share it
    first_lr_fn: Optional[Callable[[int], float]] = None
    for label in sorted(set(labels.values()) | set(group_overrides)):
        over = dict(group_overrides.get(label, {}))
        lr = float(over.get("lr", base["lr"])) * coeff
        wd = float(over.get("weight_decay", base["weight_decay"])) / coeff
        if lr not in schedules:
            schedules[lr] = build_lr_schedule(config.optimizer, lr, steps_per_epoch)
        schedule = schedules[lr]
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
