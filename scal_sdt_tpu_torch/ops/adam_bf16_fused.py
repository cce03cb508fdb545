"""Fused Adam update over stored moments, on Hopper: the port of the TPU
kernel in ``lab/micro_bf16_update.py`` (``adam_bf16_fused_update``).

The kernel (``ops/csrc/adam_bf16_fused.cu``) reads the gradient and both
moments in their storage dtypes, runs Adam in fp32 and stores the moments
back in place. Two switches make it compute each caller's chain exactly:

* ``recip_bc``: multiply by the fp32 reciprocals of the bias corrections
  ``bc = (1 - b1^t, 1 - b2^t)`` (the lab kernel; the int8 path's fp32-moment
  leaves), or divide by them (``scale_by_adam_low_memory``, the AdamW path);
* ``sr_step`` / ``sr_salt``: store nu by the counter-hash stochastic rounding
  to bf16 (``ops/sr.py``) instead of rounding to nearest;
* ``xla``: round as XLA's fusion of plain ``optax.scale_by_adam`` does under
  the JAX trainer's jit (the AdamW / Adam path without a moment dtype):
  ``1-b1``, ``1-b2`` and ``g*g`` rounded to the gradient's dtype, each
  moment's multiply-add as the one fma XLA contracts it into, and
  ``m / (bc1 * (sqrt(v / bc2) + eps))`` with the bias corrections of
  ``bias_corrections`` (the fp32 power taken in fp64); in the grouped entry
  also the decay as one fma, ``u + p * wd``. It takes fp32 moments, and in the
  grouped entry fp32 masters and updates.

Two entry points:

* ``adam_bf16_fused_update``: one leaf, returns the bias-corrected step in
  ``out_dtype`` (what the TPU kernel computes);
* ``adam_bf16_fused_apply``: every leaf of many param groups in one launch,
  over an ``AdamTable`` (``build_adam_table`` over the groups' key lists):
  Adam, then the decoupled weight decay and the schedule, then the master
  apply, the masters updated in place (bf16 masters by SR salted
  ``crc32(key) ^ MASTER_SALT`` at the train step). Nothing but the moments
  and masters reaches device memory. What a group sets (its bias
  corrections and count, its decay, its ``-lr * schedule``: a
  ``GroupStep``) goes to the card as one record per group, staged each step
  with the gradients' addresses in one copy; the betas, eps, dtypes and
  rounding are the launch's. The optimizers launch it once per step for
  every Adam group whose launch scalars and dtypes agree
  (``training/optimizers.py`` ``MultiTransform``).

Each launches the kernel for CUDA tensors and runs its plain PyTorch version
(``*_reference``: the grouped one is the optimizer's chain leaf by leaf) for
CPU tensors; neither falls back from one to the other. ``launches`` counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build
from .sr import (MASTER_SALT, NU_SALT, apply_update_reference, dither_seed, fma_f32,
                 leaf_salt, sqrt_rn, stochastic_round_bf16_cheap)

# Storage dtypes the kernel reads and writes, by the code it takes.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Elements per CTA of the grouped launch (a multiple of 8): the largest SD1.5
# leaf (29.5M elements) spreads over every SM, a 320-element leaf takes one.
# 2048-32768 ran within 1% of each other on an H100 (scripts/sweep_adam_chunks.py).
CHUNK = 4096

launches = {"adam_bf16_fused": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _factors(bc, recip_bc: bool) -> tuple[float, float]:
    """The fp32 factors the step uses: bc itself, or its fp32 reciprocal."""
    c1, c2 = (np.float32(b) for b in bc)
    if recip_bc:
        c1, c2 = np.float32(1.0) / c1, np.float32(1.0) / c2
    return float(c1), float(c2)


def _one_minus(b: float, dtype: torch.dtype) -> float:
    """``1 - b`` (python's double) as a weak-typed scalar of ``dtype`` in JAX:
    rounded to fp32, then to ``dtype``."""
    return float(torch.tensor(1.0 - b, dtype=torch.float32).to(dtype).float())


def _xla_moments(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, b1: float, b2: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The moments as XLA's fused ``scale_by_adam`` rounds them (see the
    kernel's ``xla_mu`` / ``xla_nu``)."""
    omb1, omb2 = _one_minus(b1, g.dtype), _one_minus(b2, g.dtype)
    g32 = g.float()
    gg = g32 * g32
    if g.dtype == torch.float32:
        return fma_f32(omb1, g32, mu.float() * b1), fma_f32(omb2, gg, nu.float() * b2)
    # 2-byte gradient: omb * g and omb * round(g * g) are exact in fp32
    return (fma_f32(b1, mu.float(), g32 * omb1),
            fma_f32(b2, nu.float(), gg.to(g.dtype).float() * omb2))


def adam_bf16_fused_update_reference(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                                     bc, *, b1: float, b2: float, eps: float,
                                     out_dtype: torch.dtype, recip_bc: bool,
                                     sr_step: Optional[int] = None,
                                     sr_salt: Optional[int] = None, xla: bool = False
                                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: (out, mu, nu), every operation rounded to fp32 on its
    own (``xla``: as XLA's fusion rounds); mu stored rounded to nearest, nu
    by SR when ``sr_step`` is given."""
    c1, c2 = _factors(bc, recip_bc)
    g32 = g.float()
    if xla:
        m, v = _xla_moments(g, mu, nu, b1, b2)
        out = m / (c1 * (sqrt_rn(v / v.new_full((), c2)) + eps))
        mu.copy_(m)
        nu.copy_(v)
        return out.to(out_dtype), mu, nu
    m = mu.float() * b1 + g32 * (1.0 - b1)
    v = nu.float() * b2 + (g32 * g32) * (1.0 - b2)
    if recip_bc:
        out = (m * c1) / (sqrt_rn(v * c2) + eps)
    else:
        # by 0-dim tensors: torch on CUDA multiplies by the reciprocal of a
        # python divisor, which is not the division the kernel computes
        out = (m / m.new_full((), c1)) / (sqrt_rn(v / v.new_full((), c2)) + eps)
    mu.copy_(m)
    nu.copy_(v if sr_step is None else stochastic_round_bf16_cheap(v, sr_step, sr_salt))
    return out.to(out_dtype), mu, nu


def _check_xla(xla: bool, recip_bc: bool, sr: bool, mu_dtype: torch.dtype,
               nu_dtype: torch.dtype) -> None:
    if xla and (recip_bc or sr or mu_dtype != torch.float32 or nu_dtype != torch.float32):
        raise ValueError("adam_bf16_fused: xla rounding takes fp32 moments, no SR and "
                         "recip_bc=False")


def _check(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, out_dtype: torch.dtype) -> None:
    for name, t in (("g", g), ("mu", mu), ("nu", nu)):
        if not t.is_cuda or t.device != g.device:
            raise ValueError(f"adam_bf16_fused: {name} must be a CUDA tensor on {g.device}, "
                             f"got {t.device}")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"adam_bf16_fused: {name} has dtype {t.dtype}, the kernel takes "
                            f"{sorted(map(str, DTYPE_CODES))}")
        if t.shape != g.shape or not t.is_contiguous():
            raise ValueError(f"adam_bf16_fused: {name} must be contiguous of shape "
                             f"{tuple(g.shape)}, got {tuple(t.shape)} strides {t.stride()}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"adam_bf16_fused: out_dtype {out_dtype} is not supported")


def adam_bf16_fused_update(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, bc, *,
                           b1: float, b2: float, eps: float, out_dtype: torch.dtype,
                           recip_bc: bool, sr_step: Optional[int] = None,
                           sr_salt: Optional[int] = None, xla: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step over a leaf: (out in ``out_dtype``, mu, nu), the
    moments updated in place.

    g, mu, nu: tensors of one shape, each fp32, bf16 or fp16 (the moments in
    their storage dtype). bc: the fp32 bias corrections (1 - b1^t, 1 - b2^t).
    xla: XLA's rounding of plain ``scale_by_adam`` (fp32 moments)."""
    if (sr_step is None) != (sr_salt is None):
        raise ValueError("adam_bf16_fused: give both sr_step and sr_salt, or neither")
    _check_xla(xla, recip_bc, sr_step is not None, mu.dtype, nu.dtype)
    if not g.is_cuda:
        return adam_bf16_fused_update_reference(
            g, mu, nu, bc, b1=b1, b2=b2, eps=eps, out_dtype=out_dtype, recip_bc=recip_bc,
            sr_step=sr_step, sr_salt=sr_salt, xla=xla)
    _check(g, mu, nu, out_dtype)
    out = torch.empty(g.shape, dtype=out_dtype, device=g.device)
    if g.numel() == 0:
        return out, mu, nu
    c1, c2 = _factors(bc, recip_bc)
    sr = sr_step is not None
    seed = dither_seed(sr_step, sr_salt) if sr else 0
    omb1, omb2 = _one_minus_args(b1, b2, g.dtype, xla)
    f32 = ctypes.c_float
    lib = _build.load_library()
    with torch.cuda.device(g.device):
        err = lib.ssdt_adam_bf16_fused(
            g.data_ptr(), mu.data_ptr(), nu.data_ptr(), out.data_ptr(), g.numel(),
            DTYPE_CODES[g.dtype], DTYPE_CODES[mu.dtype],
            DTYPE_CODES[nu.dtype], DTYPE_CODES[out_dtype], f32(b1), f32(b2), f32(omb1),
            f32(omb2), f32(eps), f32(c1), f32(c2), int(recip_bc), int(sr), int(xla), seed,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "adam_bf16_fused", err)
    launches["adam_bf16_fused"] += 1
    return out, mu, nu


def _one_minus_args(b1: float, b2: float, g_dtype: torch.dtype, xla: bool
                    ) -> tuple[float, float]:
    """The kernel's omb1, omb2: 1 - b (a float32 argument), rounded to the
    gradient's dtype under ``xla``."""
    if xla:
        return _one_minus(b1, g_dtype), _one_minus(b2, g_dtype)
    return 1.0 - b1, 1.0 - b2


# ---- the grouped entry ----------------------------------------------------------

def decay_and_schedule_reference(u: torch.Tensor, p: torch.Tensor, weight_decay: float,
                                 step_size: float, fma_decay: bool = False) -> torch.Tensor:
    """The decoupled weight decay and the schedule of one leaf's update, as
    the optimizers' chains round them: ``wd * p`` in the master's dtype (the
    python scalar rounded to it first, as JAX does), added in the update's
    dtype (``fma_decay``: ``u + p * wd`` rounded once, as XLA contracts it;
    fp32 masters and updates), then times the step size rounded to the
    update's dtype."""
    if weight_decay and fma_decay:
        u = fma_f32(p, weight_decay, u)
    elif weight_decay:
        u = u + (p * p.new_full((), weight_decay)).to(u.dtype)
    return u * u.new_full((), step_size)


def chunk_map(counts: Sequence[int]) -> np.ndarray:
    """(sum(counts), 2) int32 (leaf, chunk) pairs: ``counts[i]`` chunks of
    leaf i, one CTA each, in leaf order."""
    counts = np.asarray(counts, dtype=np.int64)
    leaf = np.repeat(np.arange(len(counts)), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return np.stack([leaf, np.arange(int(counts.sum())) - first], axis=1).astype(np.int32)


class GradPointers:
    """The device array of a launch's gradient addresses, followed by the
    records a launch reads anew each step (``adam_bf16_fused``'s group
    records). Autograd returns new gradient tensors every step, so both are
    written to one pinned host buffer and copied on the compute stream before
    each launch, in one copy; an event keeps the host from rewriting the
    buffer while its last copy may still be in flight."""

    def __init__(self, n: int, device: torch.device, extra_bytes: int = 0):
        self.n = n
        self.host = torch.empty(8 * n + extra_bytes, dtype=torch.uint8, pin_memory=True)
        self.dev = torch.empty(8 * n + extra_bytes, dtype=torch.uint8, device=device)
        self.copied = torch.cuda.Event()

    def upload(self, grads: Sequence[torch.Tensor], extra: Optional[np.ndarray] = None) -> int:
        """Stage the addresses of ``grads`` and the bytes of ``extra``;
        returns the device array's address (``extra`` from 8 bytes per
        gradient on)."""
        self.copied.synchronize()
        host = self.host.numpy()
        host[:8 * self.n].view(np.int64)[:] = [g.data_ptr() for g in grads]
        if extra is not None:
            host[8 * self.n:] = extra.view(np.uint8)
        self.dev.copy_(self.host, non_blocking=True)
        self.copied.record()
        return self.dev.data_ptr()


def check_grads(name: str, grads: Sequence[torch.Tensor], numels: Sequence[int],
                device: torch.device) -> tuple[list[torch.Tensor], torch.dtype]:
    """The gradients as the kernel takes them, contiguous and of one dtype,
    and that dtype; raises on a gradient that does not fit its leaf."""
    if len(grads) != len(numels):
        raise ValueError(f"{name}: {len(grads)} gradients for {len(numels)} leaves")
    dtype = grads[0].dtype if grads else torch.float32
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: gradient dtype {dtype} is not supported")
    out = []
    for i, (g, n) in enumerate(zip(grads, numels)):
        if g.dtype != dtype or g.numel() != n or g.device != device:
            raise ValueError(f"{name}: gradient {i} is {g.dtype} of {g.numel()} elements on "
                             f"{g.device}; the group takes {dtype}, {n} elements, {device}")
        out.append(g if g.is_contiguous() else g.contiguous())
    return out, dtype


def same_tensors(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


# AdamLeaf and AdamGroup of ops/csrc/adam_bf16_fused.cu
_LEAF = np.dtype([("p", "<u8"), ("mu", "<u8"), ("nu", "<u8"), ("n", "<i8"),
                  ("nu_salt", "<u4"), ("master_salt", "<u4")])
assert _LEAF.itemsize == 40
_GROUP = np.dtype([("c1", "<f4"), ("c2", "<f4"), ("nu_mix", "<u4"), ("has_wd", "<i4"),
                   ("wd_p", "<f4"), ("step_u", "<f4"), ("step_mix", "<u4"), ("pad", "<u4")])
assert _GROUP.itemsize == 32


@dataclasses.dataclass(frozen=True)
class GroupStep:
    """A param group's scalars at one step of the grouped launch: what may
    differ between the groups that share it."""
    bc: tuple             # the fp32 bias corrections at ``count``
    count: int            # the group's count after this update (nu's SR seed)
    weight_decay: float
    step_size: float      # -lr * schedule at the count before this update


@dataclasses.dataclass(eq=False)
class AdamTable:
    """The leaf table of one grouped launch over param groups: each group's
    keys, its leaves' masters and moments (the tensors the launch updates in
    place; one per leaf, group after group) and their dtypes, their two
    salts, the packed records and the chunk map (each CTA's leaf, chunk and
    group); on a card also their device copies and the staging buffer of the
    gradient addresses and group records. Built once, reused while ``holds``
    the state."""
    keys: tuple[tuple[str, ...], ...]   # per group
    params: list[torch.Tensor]          # per leaf
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    dtypes: frozenset                   # of the masters and moments
    nu_salts: list[int]
    master_salts: list[int]
    numels: list[int]
    records: np.ndarray        # _LEAF per leaf
    chunks: np.ndarray         # (n_chunks, 4) int32 (leaf, chunk, group, 0)
    device: torch.device
    dev_records: Optional[torch.Tensor] = None
    dev_chunks: Optional[torch.Tensor] = None
    staging: Optional[GradPointers] = None

    def holds(self, params: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
              nu: Sequence[torch.Tensor]) -> bool:
        """Whether the table is of exactly these tensors, one per leaf in its
        order."""
        return (same_tensors(params, self.params) and same_tensors(mu, self.mu)
                and same_tensors(nu, self.nu))


def build_adam_table(keys: Sequence[Sequence[str]], params: Sequence[torch.Tensor],
                     mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor]) -> AdamTable:
    """The leaf table of param groups: ``keys``, one list per group, and
    the leaves' masters ``params`` and moments ``mu``, ``nu`` in their
    storage dtypes, one per key in the order of ``keys``, each of its
    master's size. On a card every tensor must be contiguous, and each kind
    of one dtype over all the groups."""
    group_keys = tuple(tuple(k) for k in keys)
    sizes = [len(k) for k in group_keys]
    flat_keys = list(itertools.chain.from_iterable(group_keys))
    params, mu, nu = list(params), list(mu), list(nu)
    if not len(flat_keys) == len(params) == len(mu) == len(nu):
        raise ValueError(f"adam_bf16_fused: {len(flat_keys)} keys for {len(params)}, {len(mu)}, "
                         f"{len(nu)} masters, mu, nu")
    device = params[0].device if params else torch.device("cpu")
    for what, ts in (("master", params), ("mu", mu), ("nu", nu)):
        for k, t, p in zip(flat_keys, ts, params):
            if t.numel() != p.numel() or t.device != device:
                raise ValueError(f"adam_bf16_fused: {what} of {k} is {tuple(t.shape)} on "
                                 f"{t.device}, its master {tuple(p.shape)} on {device}")
            if device.type == "cuda" and (not t.is_contiguous() or t.dtype not in DTYPE_CODES
                                          or t.dtype != ts[0].dtype):
                raise ValueError(f"adam_bf16_fused: the {what} tensors of a launch must be "
                                 f"contiguous and of one dtype; {k} is {t.dtype}")
    rec = np.zeros(len(flat_keys), _LEAF)
    rec["p"] = [t.data_ptr() for t in params]
    rec["mu"] = [t.data_ptr() for t in mu]
    rec["nu"] = [t.data_ptr() for t in nu]
    rec["n"] = [t.numel() for t in params]
    rec["nu_salt"] = [leaf_salt(k, NU_SALT) for k in flat_keys]
    rec["master_salt"] = [leaf_salt(k, MASTER_SALT) for k in flat_keys]
    chunks = chunk_map([max(1, -(-int(n) // CHUNK)) for n in rec["n"]])
    group_of_leaf = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    chunks = np.concatenate([chunks, group_of_leaf[chunks[:, 0]][:, None],
                             np.zeros((len(chunks), 1), np.int32)], axis=1)
    table = AdamTable(group_keys, params, mu, nu, frozenset(t.dtype for t in params + mu + nu),
                      rec["nu_salt"].tolist(), rec["master_salt"].tolist(), rec["n"].tolist(),
                      rec, chunks, device)
    if device.type == "cuda" and flat_keys:
        table.dev_records = torch.from_numpy(rec.view(np.uint8)).to(device)
        table.dev_chunks = torch.from_numpy(table.chunks).to(device)
        table.staging = GradPointers(len(flat_keys), device, len(sizes) * _GROUP.itemsize)
    return table


def _check_groups(table: AdamTable, steps: Sequence[GroupStep]) -> None:
    if len(steps) != len(table.keys):
        raise ValueError(f"adam_bf16_fused: {len(steps)} group steps for a table of "
                         f"{len(table.keys)} groups")


def adam_bf16_fused_apply_reference(table: AdamTable, grads: Sequence[torch.Tensor],
                                    steps: Sequence[GroupStep], *, b1: float, b2: float,
                                    eps: float, recip_bc: bool, step: int,
                                    update_dtype: Optional[torch.dtype] = None,
                                    xla: bool = False) -> None:
    """Plain version: the optimizer's chain leaf by leaf, each leaf with its
    group's ``steps`` entry -- Adam (nu stored by SR at the group's count
    where it is narrower than fp32), the update in ``update_dtype`` (None:
    the gradient's), the group's decay and schedule, then the master apply
    at ``step`` -- with the masters and moments updated in place."""
    _check_groups(table, steps)
    if len(grads) != len(table.params):
        raise ValueError(f"adam_bf16_fused: {len(grads)} gradients for {len(table.params)} "
                         f"leaves")
    leaf_steps = (st for keys, st in zip(table.keys, steps) for _ in keys)
    for i, (g, st) in enumerate(zip(grads, leaf_steps)):
        p, nu = table.params[i], table.nu[i]
        sr = {"sr_step": st.count, "sr_salt": table.nu_salts[i]} if nu.dtype.itemsize < 4 else {}
        out = adam_bf16_fused_update_reference(
            g.contiguous(), table.mu[i], nu, st.bc, b1=b1, b2=b2, eps=eps,
            out_dtype=update_dtype or g.dtype, recip_bc=recip_bc, xla=xla, **sr)[0]
        u = decay_and_schedule_reference(out, p, st.weight_decay, st.step_size, fma_decay=xla)
        p.copy_(apply_update_reference(p, u, step, table.master_salts[i]))


def _group_record(st: GroupStep, recip_bc: bool, p_dtype: torch.dtype, u_dtype: torch.dtype
                  ) -> tuple:
    """A group's AdamGroup fields but the step's seed, its scalars rounded as
    the chain's ``new_full`` rounds them."""
    c1, c2 = _factors(st.bc, recip_bc)
    wd_p = torch.full((), st.weight_decay, dtype=p_dtype).item()
    step_u = torch.full((), st.step_size, dtype=u_dtype).item()
    return (c1, c2, dither_seed(st.count, 0), int(bool(st.weight_decay)), wd_p, step_u, 0, 0)


def group_records(steps: Sequence[GroupStep], *, recip_bc: bool, p_dtype: torch.dtype,
                  u_dtype: torch.dtype, step: int) -> np.ndarray:
    """The AdamGroup records of a launch at train step ``step``: one per
    group, its ``steps`` entry's scalars as the kernel takes them. Groups
    that share a ``GroupStep`` object (a LoRA run's groups take one of a few
    lrs) share its record's computation."""
    slots: dict[int, int] = {}
    which = [slots.setdefault(id(st), len(slots)) for st in steps]
    unique = list({id(st): st for st in steps}.values())
    records = np.array([_group_record(st, recip_bc, p_dtype, u_dtype) for st in unique],
                       _GROUP)[which]
    records["step_mix"] = dither_seed(step, 0)
    return records


def adam_bf16_fused_apply(table: AdamTable, grads: Sequence[torch.Tensor],
                          steps: Sequence[GroupStep], *, b1: float, b2: float, eps: float,
                          recip_bc: bool, step: int, update_dtype: Optional[torch.dtype] = None,
                          xla: bool = False) -> None:
    """One Adam step and master apply over every leaf of every group of
    ``table``, in one launch on a card; masters and moments are updated in
    place.

    grads: one per leaf, in the table's order; steps: one ``GroupStep`` per
    group (its bias corrections at its count after this update, its decay
    and its ``-lr * schedule``). The rest is the launch's: ``step``, the
    train step (the master SR's seed); update_dtype: the update's dtype
    before the apply (None: the gradients'); xla: XLA's rounding of plain
    ``scale_by_adam`` and of the decay (fp32 moments, masters and
    updates)."""
    kw = dict(b1=b1, b2=b2, eps=eps, recip_bc=recip_bc, step=step, update_dtype=update_dtype,
              xla=xla)
    if xla:
        if recip_bc or table.dtypes - {torch.float32} or update_dtype not in (None, torch.float32):
            raise ValueError("adam_bf16_fused: xla rounding takes fp32 masters, moments and "
                             "updates, and recip_bc=False")
    if table.device.type != "cuda":
        adam_bf16_fused_apply_reference(table, grads, steps, **kw)
        return
    _check_groups(table, steps)
    if not table.params:
        return
    gs, g_dtype = check_grads("adam_bf16_fused", grads, table.numels, table.device)
    u_dtype = update_dtype or g_dtype
    p_dtype, mu_dtype, nu_dtype = (ts[0].dtype for ts in (table.params, table.mu, table.nu))
    if u_dtype not in DTYPE_CODES:
        raise TypeError(f"adam_bf16_fused: update dtype {u_dtype} is not supported")
    records = group_records(steps, recip_bc=recip_bc, p_dtype=p_dtype, u_dtype=u_dtype,
                            step=step)
    f32 = ctypes.c_float
    lib = _build.load_library()
    with torch.cuda.device(table.device):
        staged = table.staging.upload(gs, records)
        err = lib.ssdt_adam_bf16_group(
            table.dev_records.data_ptr(), staged + 8 * len(gs), staged,
            table.dev_chunks.data_ptr(), len(table.chunks), CHUNK, DTYPE_CODES[g_dtype],
            DTYPE_CODES[mu_dtype], DTYPE_CODES[nu_dtype], DTYPE_CODES[p_dtype],
            DTYPE_CODES[u_dtype], f32(b1), f32(b2),
            *map(f32, _one_minus_args(b1, b2, g_dtype, xla)), f32(eps), int(recip_bc),
            int(nu_dtype.itemsize < 4), int(xla), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "adam_bf16_fused", err)
    launches["adam_bf16_fused"] += 1
