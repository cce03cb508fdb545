"""The optimizer families the JAX package builds from optax without a Pallas
kernel: Lion, Adafactor, Prodigy, D-Adapt AdamW and SGD (port of the
branches of ``scal_sdt_tpu/training/optimizers.py`` ``_group_transform``
and of the optax transforms they chain).

Each group runs its optax chain with the JAX package's arithmetic, operation
by operation: every product, sum and quotient is rounded to the dtype JAX
gives it (a python scalar takes the dtype of the array it meets, a 0-dim
state scalar is strongly typed and promotes), so the updates equal JAX's
eager ones bit for bit wherever the chain is elementwise. The reductions
(Adafactor's means, Prodigy's and D-Adapt's dot products and sums) add in
another order than XLA does, and agree to a few ulps.

* Lion: ``optax.scale_by_lion`` (``u = sign((1-b1) g + b1 mu)``,
  ``mu <- b2 mu + (1-b2) g`` stored in ``mu_dtype``), then the decay and the
  schedule.
* Adafactor: ``optax.scale_by_factored_rms(decay_rate=b2)`` (``b2`` is the
  exponent of the decay schedule ``1 - (count+1)^-b2``) and
  ``clip_by_block_rms(1.0)``, then the decay and the schedule. A block is a
  leaf, or, where the JAX trainer packs (``training/packing.py``), a slab
  (one zero-padded 1-D block: unfactored, one RMS clip over the slab,
  padding counted in the mean) or a stack; the state is kept per block,
  under JAX's keys.
* Prodigy and D-Adapt AdamW: ``optax.contrib.prodigy`` /
  ``dadapt_adamw`` with ``lr * schedule(count)`` inside; their scalar state
  (``estim_lr``, ``numerator_weighted``) stays on the device as 0-dim
  tensors of the params' lowest dtype, as optax keeps it. Prodigy's
  ``params0`` is a copy of the masters, which the step updates in place.
  Under sharded masters (``GroupOwners``) their group-wide sums add the
  owners' partial sums, and a rank that owns none of a group's leaves
  still takes part and keeps the same scalars.
* SGD: the decay, then the schedule (no momentum, as in JAX).

The decay is ``optax.add_decayed_weights`` (``wd * p`` in the master's
dtype), the schedule ``optax.scale_by_schedule`` (``-lr * schedule(count)``
rounded to the update's dtype). ``update`` returns the updates;
``update_and_apply`` adds them to the masters in place as
``training/step.py``'s ``apply_updates`` does (bf16 masters by SR salted
``crc32(key) ^ MASTER_SALT`` at the train step). Lists of leaves run through
``torch._foreach_*`` ops, which round as their per-tensor ops do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.sr import MASTER_SALT, apply_update_reference, leaf_salt, sqrt_rn
from .packing import PackSpec
from .schedules import Schedule

Tensors = dict[str, torch.Tensor]
Leaves = list[torch.Tensor]


# ---- JAX's rounding, on lists of leaves ---------------------------------------

def _rounded(s: float, dtype: torch.dtype) -> float:
    """A python scalar rounded to ``dtype``, as JAX rounds a weakly typed
    scalar to the array it meets (torch's foreach ops would use it in fp32)."""
    return torch.tensor(s, dtype=dtype).item()


def _scale(xs: Leaves, s: float) -> Leaves:
    """``s * x`` for a python scalar ``s``, in each leaf's dtype."""
    return torch._foreach_mul(xs, _rounded(s, xs[0].dtype)) if xs else []


def _times(xs: Leaves, t: torch.Tensor) -> Leaves:
    """``t * x`` for a 0-dim tensor ``t``, in the promoted dtype (a 0-dim
    JAX array is strongly typed)."""
    if not xs:
        return []
    dt = torch.promote_types(xs[0].dtype, t.dtype)
    return torch._foreach_mul(_cast(xs, dt), t.to(dt))


def _plus(xs: Leaves, t: torch.Tensor) -> Leaves:
    """``x + t`` for a 0-dim tensor ``t``, in the promoted dtype."""
    if not xs:
        return []
    dt = torch.promote_types(xs[0].dtype, t.dtype)
    return torch._foreach_add(_cast(xs, dt), t.to(dt))


def _cast(xs: Leaves, dtype: torch.dtype) -> Leaves:
    return [x if x.dtype == dtype else x.to(dtype) for x in xs]


def _div_scalar(xs: Leaves, s: float) -> Leaves:
    """``x / s`` (a true division, also on a card) in each leaf's dtype."""
    return torch._foreach_div(xs, xs[0].new_full((), s)) if xs else []


def _add_scalar(xs: Leaves, s: float) -> Leaves:
    return torch._foreach_add(xs, _rounded(s, xs[0].dtype)) if xs else []


def _sqrt(xs: Leaves) -> Leaves:
    """The correctly rounded square roots (``ops/sr.py`` ``sqrt_rn``)."""
    if xs and xs[0].is_cuda:
        return torch._foreach_sqrt(xs)
    return [sqrt_rn(x) for x in xs]


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``x ** -0.5`` as XLA's pow rounds it on the CPU (within one ulp in
    about 1e-3 of the elements): in fp64, rounded to x's dtype through fp32."""
    return x.double().pow(-0.5).float().to(x.dtype)


def _scalar(value, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.full((), float(value), dtype=dtype, device=like.device)


def int_pow_f32(x: float, n: int) -> np.float32:
    """``x ** n`` for an int32 count as XLA computes it: fp32 repeated
    squaring."""
    x, r = np.float32(x), np.float32(1.0)
    while n:
        if n & 1:
            r = np.float32(r * x)
        x = np.float32(x * x)
        n >>= 1
    return r


def dadapt_bias_correction(b1: float, b2: float, count: int) -> np.float32:
    """``sqrt(1 - b2^count) / (1 - b1^count)`` in fp32, as Prodigy and
    D-Adapt compute it (the square root by fp64 pow, as XLA's rounds)."""
    a = np.float32(1.0) - int_pow_f32(b2, count)
    return np.float32(np.float32(np.float64(a) ** 0.5) / (np.float32(1.0) - int_pow_f32(b1, count)))


def decay_and_schedule(us: Leaves, ps: Leaves, weight_decay: float,
                       step_size: Optional[float]) -> Leaves:
    """``add_decayed_weights`` (skipped at 0, as the JAX chain leaves it out)
    then ``scale_by_schedule`` (None: no schedule)."""
    if weight_decay and us:
        us = torch._foreach_add(us, _scale(ps, weight_decay))
    if step_size is not None and us:
        us = _scale(us, step_size)
    return us


def apply_in_place(keys: Sequence[str], ps: Leaves, us: Leaves, step: int) -> None:
    """The masters plus their updates, in place (``apply_updates``)."""
    if not ps:
        return
    if ps[0].dtype != torch.bfloat16:
        torch._foreach_add_(ps, _cast(us, ps[0].dtype))
        return
    for k, p, u in zip(keys, ps, us):
        p.copy_(apply_update_reference(p, u, step, leaf_salt(k, MASTER_SALT)))


def vdot_sum(xs: Leaves, ys: Leaves) -> torch.Tensor:
    """``optax.tree.vdot``: the sum over leaves of their dot products, in
    fp32 (XLA adds in another order: a few ulps)."""
    if not xs:
        return torch.zeros(())
    return torch.stack([torch.dot(x.reshape(-1).float(), y.reshape(-1).float())
                        for x, y in zip(xs, ys)]).sum()


def abs_sum(xs: Leaves) -> torch.Tensor:
    """``optax.tree.sum(abs(x))`` in fp32."""
    if not xs:
        return torch.zeros(())
    return torch.stack(torch._foreach_norm(xs, 1, dtype=torch.float32)).sum()


def _leaves(d: Tensors, keys: Sequence[str]) -> Leaves:
    return [d[k] for k in keys]


def _copy_into(dst: Leaves, src: Leaves) -> None:
    if dst:
        torch._foreach_copy_(dst, src)


class _Chain:
    """The group protocol's ``update_and_apply`` for a chain without a fused
    kernel: ``update``, then the master apply."""

    def update_and_apply(self, grads: Tensors, state, params: Tensors, step: int):
        updates, state = self.update(grads, state, params)
        keys = sorted(params)
        apply_in_place(keys, _leaves(params, keys), _leaves(updates, keys), step)
        return state


def step_size_of(lr: float, schedule: Schedule, count: int) -> float:
    """``-lr * schedule(count)`` in fp32; optax's ``scale_by_schedule`` sees
    the count before the update."""
    return float(np.float32(-lr) * np.float32(schedule(count)))


def _lr_times_schedule(lr: float, schedule: Schedule, count: int) -> float:
    return float(np.float32(lr) * np.float32(schedule(count)))


# ---- SGD ----------------------------------------------------------------------

@dataclasses.dataclass
class SGDState:
    count: int


@dataclasses.dataclass(frozen=True)
class SGD(_Chain):
    lr: float
    weight_decay: float
    schedule: Schedule

    def init(self, params: Tensors) -> SGDState:
        return SGDState(0)

    def update(self, grads: Tensors, state: SGDState, params: Tensors
               ) -> tuple[Tensors, SGDState]:
        keys = sorted(grads)
        us = decay_and_schedule(_leaves(grads, keys), _leaves(params, keys), self.weight_decay,
                                step_size_of(self.lr, self.schedule, state.count))
        return dict(zip(keys, us)), SGDState(state.count + 1)


# ---- Lion ---------------------------------------------------------------------

@dataclasses.dataclass
class LionState:
    count: int
    mu: Tensors


@dataclasses.dataclass(frozen=True)
class Lion(_Chain):
    lr: float
    b1: float
    b2: float
    weight_decay: float
    schedule: Schedule
    mu_dtype: Optional[torch.dtype] = None   # None: the param dtype

    def init(self, params: Tensors) -> LionState:
        return LionState(0, {k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                             for k, p in params.items()})

    def update(self, grads: Tensors, state: LionState, params: Tensors
               ) -> tuple[Tensors, LionState]:
        keys = sorted(grads)
        if not keys:
            return {}, LionState(state.count + 1, state.mu)
        g, mu = _leaves(grads, keys), _leaves(state.mu, keys)
        us = torch._foreach_sign(torch._foreach_add(_scale(g, 1.0 - self.b1),
                                                    _scale(mu, self.b1)))
        new_mu = torch._foreach_add(_scale(g, 1 - self.b2), _scale(mu, self.b2))
        _copy_into(mu, new_mu)   # cast to mu_dtype, rounded to nearest
        us = decay_and_schedule(us, _leaves(params, keys), self.weight_decay,
                                step_size_of(self.lr, self.schedule, state.count))
        return dict(zip(keys, us)), LionState(state.count + 1, state.mu)


# ---- Adafactor ----------------------------------------------------------------

MIN_DIM_SIZE_TO_FACTOR = 128
ADAFACTOR_EPSILON = 1e-30


def factored_dims(shape: Sequence[int]) -> Optional[tuple[int, int]]:
    """optax's ``_factored_dims``: the two largest axes, when the second
    largest has at least 128 elements."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


@dataclasses.dataclass(frozen=True)
class Block:
    """A block Adafactor sees: a leaf (``members == (key,)``, ``kind``
    'leaf'), a slab of ``padded`` elements or an (N, *shape) stack."""
    key: str
    kind: str                       # 'leaf', 'slab' or 'stack'
    members: tuple[str, ...]
    shape: tuple[int, ...]          # the block's own shape
    offsets: tuple[int, ...] = ()   # slab: each member's offset


def adafactor_blocks(keys: Sequence[str], shapes: dict[str, tuple[int, ...]],
                     spec: Optional[PackSpec]) -> list[Block]:
    """The blocks of a group's ``keys``: the spec's slabs and stacks whose
    members are all in the group, and the other keys as leaves."""
    keyset, blocks, taken = set(keys), [], set()
    if spec is not None:
        for slab_key, padded, slots in spec.slabs:
            if slots and all(s.key in keyset for s in slots):
                blocks.append(Block(slab_key, "slab", tuple(s.key for s in slots), (padded,),
                                    tuple(s.offset for s in slots)))
                taken.update(s.key for s in slots)
        for stack_key, members, shape in spec.stacks:
            if members and all(k in keyset for k in members):
                blocks.append(Block(stack_key, "stack", tuple(members),
                                    (len(members),) + tuple(shape)))
                taken.update(members)
    blocks += [Block(k, "leaf", (k,), tuple(shapes[k])) for k in sorted(keyset - taken)]
    return sorted(blocks, key=lambda b: b.key)


def _gather(block: Block, leaves: Tensors) -> torch.Tensor:
    """A block's tensor from its members (a slab zero padded at the end)."""
    if block.kind == "leaf":
        return leaves[block.key]
    if block.kind == "stack":
        return torch.stack([leaves[k] for k in block.members])
    parts = [leaves[k].reshape(-1) for k in block.members]
    pad = block.shape[0] - sum(p.numel() for p in parts)
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def _scatter(block: Block, x: torch.Tensor, shapes: dict[str, tuple[int, ...]]) -> Tensors:
    if block.kind == "leaf":
        return {block.key: x}
    if block.kind == "stack":
        return {k: x[i] for i, k in enumerate(block.members)}
    out = {}
    for k, off in zip(block.members, block.offsets):
        n = int(np.prod(shapes[k])) if shapes[k] else 1
        out[k] = x[off:off + n].reshape(shapes[k])
    return out


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean``: an fp32 sum divided by the count (a true division),
    in x's dtype."""
    s = x.float().sum() if dim is None else x.float().sum(dim=dim, keepdim=keepdim)
    n = x.numel() if dim is None else x.shape[dim]
    return (s / s.new_full((), n)).to(x.dtype)


@dataclasses.dataclass
class FactoredState:
    """optax's ``FactoredState``, per block key: ``v_row`` / ``v_col`` for a
    factored block and ``v`` for the others, with optax's (1,) zeros in the
    slots a block does not use."""
    count: int
    v_row: Tensors
    v_col: Tensors
    v: Tensors


@dataclasses.dataclass(frozen=True)
class Adafactor(_Chain):
    lr: float
    decay_rate: float               # the config's b2: an exponent
    weight_decay: float
    schedule: Schedule
    pack_spec: Optional[PackSpec] = None

    def blocks(self, params: Tensors) -> list[Block]:
        return adafactor_blocks(sorted(params), {k: tuple(p.shape) for k, p in params.items()},
                                self.pack_spec)

    def init(self, params: Tensors) -> FactoredState:
        v_row, v_col, v = {}, {}, {}
        for b in self.blocks(params):
            p = params[b.members[0]]
            one = lambda: torch.zeros(1, dtype=p.dtype, device=p.device)  # noqa: E731
            dims = factored_dims(b.shape)
            if dims is not None:
                d1, d0 = dims
                v_row[b.key] = torch.zeros(np.delete(b.shape, d0).tolist(), dtype=p.dtype,
                                           device=p.device)
                v_col[b.key] = torch.zeros(np.delete(b.shape, d1).tolist(), dtype=p.dtype,
                                           device=p.device)
                v[b.key] = one()
            else:
                v_row[b.key], v_col[b.key] = one(), one()
                v[b.key] = torch.zeros(b.shape, dtype=p.dtype, device=p.device)
        return FactoredState(0, v_row, v_col, v)

    def _decay_rate_t(self, count: int) -> np.float32:
        """``1 - (count+1)^-decay_rate`` in fp32 (the pow in fp64, as XLA's
        rounds)."""
        t = np.float64(np.float32(count + 1))
        return np.float32(np.float32(1.0) - np.float32(t ** np.float64(np.float32(
            -self.decay_rate))))

    def _scale_block(self, b: Block, g: torch.Tensor, state: FactoredState,
                     rate: torch.Tensor) -> torch.Tensor:
        """scale_by_factored_rms on one block; stores its new statistics."""
        dtype = state.v[b.key].dtype
        grad_sqr = g * g + g.new_full((), ADAFACTOR_EPSILON)
        keep = 1.0 - rate   # a 0-dim fp32 tensor: (1.0 - decay_rate_t)
        dims = factored_dims(b.shape)
        if dims is not None:
            d1, d0 = dims
            # fp32: the 0-dim fp32 rate promotes the statistics
            v_row = (rate * state.v_row[b.key].float()
                     + keep * _mean(grad_sqr, d0).float()).to(dtype)
            v_col = (rate * state.v_col[b.key].float()
                     + keep * _mean(grad_sqr, d1).float()).to(dtype)
            state.v_row[b.key].copy_(v_row)
            state.v_col[b.key].copy_(v_col)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = _mean(v_row, reduced_d1, keepdim=True)
            row_factor = _rsqrt(v_row / row_col_mean)
            col_factor = _rsqrt(v_col)
            return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        v = (rate * state.v[b.key].float() + keep * grad_sqr.float()).to(dtype)
        state.v[b.key].copy_(v)
        return g * _rsqrt(v)

    def update(self, grads: Tensors, state: FactoredState, params: Tensors
               ) -> tuple[Tensors, FactoredState]:
        shapes = {k: tuple(p.shape) for k, p in params.items()}
        any_p = next(iter(params.values()), None)
        if any_p is None:
            return {}, FactoredState(state.count + 1, state.v_row, state.v_col, state.v)
        rate = _scalar(self._decay_rate_t(state.count), any_p)
        step_size = step_size_of(self.lr, self.schedule, state.count)
        updates: Tensors = {}
        for b in self.blocks(params):
            u = self._scale_block(b, _gather(b, grads), state, rate)
            # clip_by_block_rms(1.0): one RMS over the whole block
            rms = sqrt_rn(_mean(u * u)) / u.new_full((), 1.0)
            u = u / torch.maximum(u.new_full((), 1.0), rms)
            u = decay_and_schedule([u], [_gather(b, params)], self.weight_decay, step_size)[0]
            updates.update(_scatter(b, u, shapes))
        return updates, FactoredState(state.count + 1, state.v_row, state.v_col, state.v)


# ---- Prodigy and D-Adapt AdamW --------------------------------------------------

def _lowest_dtype(params: Tensors) -> torch.dtype:
    """optax.tree.dtype(params, 'lowest') over float leaves."""
    dts = {p.dtype for p in params.values()}
    for dt in (torch.bfloat16, torch.float16, torch.float32, torch.float64):
        if dt in dts:
            return dt
    return torch.float32


def _device(params: Tensors) -> torch.device:
    return next(iter(params.values())).device if params else torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class GroupOwners:
    """A group whose leaves are split over owners (sharded masters):
    ``group_sum`` adds a 0-dim fp32 tensor over the owners, ``dtypes`` are
    the (gradient, master) dtypes an owner of no leaf reckons with."""
    group_sum: object
    dtypes: tuple[torch.dtype, torch.dtype]

    def zero_sum(self) -> torch.Tensor:
        return self.group_sum(torch.zeros((), dtype=torch.float32))


def _summed(partial: torch.Tensor, owners: Optional[GroupOwners]) -> torch.Tensor:
    """A group-wide fp32 sum: the owners' partial sums added (difference (r):
    another order than one process's)."""
    return partial if owners is None else owners.group_sum(partial)


def _state_dtype(params: Tensors, owners: Optional[GroupOwners]) -> torch.dtype:
    """The scalar state's dtype: the params' lowest, or the masters' for an
    owner of none of the group's leaves."""
    return _lowest_dtype(params) if params or owners is None else owners.dtypes[1]


@dataclasses.dataclass
class ProdigyState:
    count: int
    exp_avg: Tensors
    exp_avg_sq: Tensors
    grad_sum: Tensors
    params0: Tensors               # a copy of the masters at init
    estim_lr: torch.Tensor         # 0-dim, the params' lowest dtype
    numerator_weighted: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Prodigy(_Chain):
    lr: float
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    beta3: Optional[float] = None
    eps: float = 1e-8
    estim_lr0: float = 1e-6
    estim_lr_coef: float = 1.0
    weight_decay: float = 0.0
    safeguard_warmup: bool = False
    owners: Optional[GroupOwners] = None

    def init(self, params: Tensors) -> ProdigyState:
        dt, dev = _state_dtype(params, self.owners), _device(params)
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        return ProdigyState(
            0, zeros(), zeros(), zeros(), {k: p.detach().clone() for k, p in params.items()},
            torch.full((), self.estim_lr0, dtype=dt, device=dev),
            torch.zeros((), dtype=dt, device=dev))

    def update(self, grads: Tensors, state: ProdigyState, params: Tensors
               ) -> tuple[Tensors, ProdigyState]:
        keys = sorted(grads)
        if not keys:
            if self.owners is not None:   # an owner of none of the group's leaves
                self._scalars(state, self.owners.zero_sum(), self.owners.zero_sum())
            return {}, dataclasses.replace(state, count=state.count + 1)
        b1, b2 = self.b1, self.b2
        beta3 = self.beta3 if self.beta3 is not None else b2 ** 0.5
        g, p = _leaves(grads, keys), _leaves(params, keys)
        ea, eas, gs, p0 = (_leaves(d, keys) for d in (state.exp_avg, state.exp_avg_sq,
                                                      state.grad_sum, state.params0))
        estim_lr, nw = state.estim_lr, state.numerator_weighted
        e_dt = estim_lr.dtype
        sched = _scalar(_lr_times_schedule(self.lr, self.schedule, state.count), estim_lr)
        bc = _scalar(dadapt_bias_correction(b1, b2, state.count + 1), estim_lr)
        dlr = (estim_lr.float() * sched * bc).to(e_dt)
        dg = _times(g, estim_lr)
        param_diff = torch._foreach_sub(p0, p)
        numerator_acum = _summed(vdot_sum(g, param_diff), self.owners).to(
            torch.promote_types(g[0].dtype, p[0].dtype))
        new_ea = torch._foreach_add(_scale(ea, b1), _scale(dg, 1 - b1))
        new_eas = torch._foreach_add(_scale(eas, b2),
                                     torch._foreach_mul(_scale(dg, 1 - b2), dg))
        if self.safeguard_warmup:
            inc = _div_scalar(_times(dg, estim_lr), self.estim_lr0)
        else:
            inc = _div_scalar(_times(dg, dlr), self.estim_lr0)
        new_gs = torch._foreach_add(_scale(gs, beta3), inc)
        _copy_into(ea, new_ea)
        _copy_into(eas, new_eas)
        _copy_into(gs, new_gs)
        nw_new = nw * nw.new_full((), beta3)
        ratio = estim_lr / estim_lr.new_full((), self.estim_lr0)
        nw_new = nw_new + (ratio * dlr) * numerator_acum
        denominator = _summed(abs_sum(gs), self.owners).to(gs[0].dtype)
        lr_estimate = (nw_new.new_full((), self.estim_lr_coef) * nw_new) / denominator
        new_estim_lr = torch.maximum(estim_lr, lr_estimate)
        # -wd * dlr * p - dlr * ea / (sqrt(eas) + estim_lr * eps), the new estim_lr
        den = _plus(_sqrt(eas), new_estim_lr * new_estim_lr.new_full((), self.eps))
        step = torch._foreach_div(_times(ea, dlr), den)
        wd_dlr = dlr.new_full((), -self.weight_decay) * dlr
        us = torch._foreach_sub(_times(p, wd_dlr), step)
        nw.copy_(nw_new)
        estim_lr.copy_(new_estim_lr)
        return dict(zip(keys, us)), dataclasses.replace(state, count=state.count + 1)

    def _scalars(self, state: ProdigyState, numerator_acum: torch.Tensor,
                 denominator: torch.Tensor) -> None:
        """The scalar half of ``update`` on a rank that owns none of the
        group's leaves: the group's sums from the owners that do."""
        estim_lr, nw = state.estim_lr, state.numerator_weighted
        e_dt, (g_dt, p_dt) = estim_lr.dtype, self.owners.dtypes
        beta3 = self.beta3 if self.beta3 is not None else self.b2 ** 0.5
        sched = _scalar(_lr_times_schedule(self.lr, self.schedule, state.count), estim_lr)
        bc = _scalar(dadapt_bias_correction(self.b1, self.b2, state.count + 1), estim_lr)
        dlr = (estim_lr.float() * sched * bc).to(e_dt)
        numerator_acum = numerator_acum.to(torch.promote_types(g_dt, p_dt)).to(nw.device)
        nw_new = nw * nw.new_full((), beta3)
        ratio = estim_lr / estim_lr.new_full((), self.estim_lr0)
        nw_new = nw_new + (ratio * dlr) * numerator_acum
        denominator = denominator.to(p_dt).to(nw.device)
        lr_estimate = (nw_new.new_full((), self.estim_lr_coef) * nw_new) / denominator
        nw.copy_(nw_new)
        estim_lr.copy_(torch.maximum(estim_lr, lr_estimate))


@dataclasses.dataclass
class DAdaptState:
    count: int
    exp_avg: Tensors
    exp_avg_sq: Tensors
    grad_sum: Tensors
    estim_lr: torch.Tensor         # 0-dim, the params' lowest dtype
    numerator_weighted: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DAdaptAdamW(_Chain):
    lr: float
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    estim_lr0: float = 1e-6
    weight_decay: float = 0.0
    owners: Optional[GroupOwners] = None

    def init(self, params: Tensors) -> DAdaptState:
        dt, dev = _state_dtype(params, self.owners), _device(params)
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        return DAdaptState(0, zeros(), zeros(), zeros(),
                           torch.full((), self.estim_lr0, dtype=dt, device=dev),
                           torch.zeros((), dtype=dt, device=dev))

    def update(self, grads: Tensors, state: DAdaptState, params: Tensors
               ) -> tuple[Tensors, DAdaptState]:
        keys = sorted(grads)
        if not keys:
            if self.owners is not None:   # an owner of none of the group's leaves
                self._scalars(state, self.owners.zero_sum(), self.owners.zero_sum())
            return {}, dataclasses.replace(state, count=state.count + 1)
        b1, b2 = self.b1, self.b2
        sb2 = b2 ** 0.5
        g, p = _leaves(grads, keys), _leaves(params, keys)
        ea, eas, gs = (_leaves(d, keys) for d in (state.exp_avg, state.exp_avg_sq,
                                                  state.grad_sum))
        estim_lr, nw = state.estim_lr, state.numerator_weighted
        sched = _scalar(_lr_times_schedule(self.lr, self.schedule, state.count), estim_lr)
        bc = _scalar(dadapt_bias_correction(b1, b2, state.count + 1), estim_lr)
        dlr = (estim_lr.float() * sched * bc).to(nw.dtype)
        s_weighted = torch._foreach_div(gs, _add_scalar(_sqrt(eas), self.eps))
        numerator_acum = _summed(vdot_sum(g, s_weighted), self.owners).to(
            torch.promote_types(g[0].dtype, p[0].dtype))
        new_ea = torch._foreach_add(_scale(ea, b1), _times(g, dlr.new_full((), 1 - b1) * dlr))
        new_eas = torch._foreach_add(_scale(eas, b2), torch._foreach_mul(_scale(g, 1 - b2), g))
        new_gs = torch._foreach_add(_scale(gs, sb2), _times(g, dlr.new_full((), 1 - sb2) * dlr))
        _copy_into(ea, new_ea)
        _copy_into(eas, new_eas)
        _copy_into(gs, new_gs)
        grad_sum_l1 = _summed(abs_sum(gs), self.owners).to(gs[0].dtype)
        nw_new = (nw * nw.new_full((), sb2)
                  + (dlr.new_full((), 1 - sb2) * dlr) * numerator_acum)
        d_estimate = nw_new / (grad_sum_l1 * grad_sum_l1.new_full((), 1 - sb2))
        new_estim_lr = torch.maximum(estim_lr, d_estimate)
        step = torch._foreach_div(ea, _add_scalar(_sqrt(eas), self.eps))
        wd_dlr = dlr.new_full((), -self.weight_decay) * dlr
        us = torch._foreach_sub(_times(p, wd_dlr), step)
        nw.copy_(nw_new)
        estim_lr.copy_(new_estim_lr)
        return dict(zip(keys, us)), dataclasses.replace(state, count=state.count + 1)

    def _scalars(self, state: DAdaptState, numerator_acum: torch.Tensor,
                 grad_sum_l1: torch.Tensor) -> None:
        """The scalar half of ``update`` on a rank that owns none of the
        group's leaves: the group's sums from the owners that do."""
        estim_lr, nw = state.estim_lr, state.numerator_weighted
        g_dt, p_dt = self.owners.dtypes
        sb2 = self.b2 ** 0.5
        sched = _scalar(_lr_times_schedule(self.lr, self.schedule, state.count), estim_lr)
        bc = _scalar(dadapt_bias_correction(self.b1, self.b2, state.count + 1), estim_lr)
        dlr = (estim_lr.float() * sched * bc).to(nw.dtype)
        numerator_acum = numerator_acum.to(torch.promote_types(g_dt, p_dt)).to(nw.device)
        grad_sum_l1 = grad_sum_l1.to(p_dt).to(nw.device)
        nw_new = (nw * nw.new_full((), sb2)
                  + (dlr.new_full((), 1 - sb2) * dlr) * numerator_acum)
        d_estimate = nw_new / (grad_sum_l1 * grad_sum_l1.new_full((), 1 - sb2))
        nw.copy_(nw_new)
        estim_lr.copy_(torch.maximum(estim_lr, d_estimate))
