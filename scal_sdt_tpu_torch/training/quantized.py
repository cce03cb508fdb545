"""Int8 block-quantized Adam moments (port of
``scal_sdt_tpu/training/quantized.py``): the stand-in for bitsandbytes'
AdamW8bit, the reference's recommended optimizer.

Both Adam moments of a leaf are stored as int8 payloads with one fp32 absmax
scale per 256-element block of the leaf's (lead, minor) view: ``lead`` merges
leading dims until the trailing product fits ``_MAX_NB`` blocks, and the
minor is right-padded to whole blocks. The layout and shapes are the JAX
package's, so a state carries across unchanged: payloads (lead, nb*256)
int8, scales (lead, nb) fp32. Leaves below ``SSDT_INT8_FUSED_MIN`` elements
(default 2^18; the JAX package reads the same variable) keep plain fp32
moments in their natural shape and have no scale entry.

Under the JAX trainer's packing (``training/packing.py``) JAX decides this
per container, and so does the port given the run's ``PackSpec``
(``int8_views``): a slab is 1-D, so its members keep fp32 moments; a
stack's members are int8 when the stack is, each in its share of the
stack's view, owning whole rows of its payloads and scales
(``stack_member_view``), so a packed JAX state carries across bit for bit
(``convert/from_jax.py``) and the blocks are JAX's.

``Adam8bit.update`` runs the int8 leaves through ``ops/adam8_fused.py`` and
the fp32-moment leaves through ``ops/adam_bf16_fused.py`` (reciprocal bias
corrections, output in the gradient's dtype, nu rounded to nearest), one
launch per leaf on the card. The train step's path adds the decay, the
schedule and the master apply: ``Adam8bit.update_and_apply_int8`` runs a
group's int8 leaves in one launch over its leaf table (cached in the
caller's dict while the state holds the same tensors), and its fp32-moment
leaves join the other groups' in one ``adam_bf16_fused`` launch per step
(``training/optimizers.py`` ``MultiTransform``). The plain versions run on
the CPU. The state is updated in place.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.adam8_fused import (BLOCK, adam8_fused_apply, adam8_fused_update, build_adam8_table,
                               dequantize_blocks as _dequantize_leaf,
                               quantize_blocks as _quantize_leaf)
from ..ops.adam_bf16_fused import adam_bf16_fused_update

# n_blocks cap of a leaf view: bigger trailing products merge more leading dims
_MAX_NB = 128

Tensors = dict[str, torch.Tensor]


def _leaf_view(shape) -> tuple[int, int, int]:
    """(lead, minor, n_blocks) for a leaf shape: leading dims merge until the
    trailing product fits _MAX_NB blocks; a minor shorter than one block
    flattens the whole leaf instead (no per-row padding)."""
    shape = tuple(int(d) for d in shape)
    if len(shape) <= 1:
        lead, minor = 1, math.prod(shape)
    else:
        k = 1
        while k < len(shape) - 1 and math.prod(shape[k:]) > _MAX_NB * BLOCK:
            k += 1
        lead, minor = math.prod(shape[:k]), math.prod(shape[k:])
    if minor < BLOCK:
        lead, minor = 1, lead * minor
    return lead, minor, -(-minor // BLOCK)


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    """leaf -> (lead, n_blocks, BLOCK), right-padding the flattened minor."""
    lead, minor, nb = _leaf_view(x.shape)
    return F.pad(x.reshape(lead, minor), (0, nb * BLOCK - minor)).view(lead, nb, BLOCK)


def _from_blocks(v: torch.Tensor, shape) -> torch.Tensor:
    lead, minor, nb = _leaf_view(shape)
    return v.reshape(lead, nb * BLOCK)[:, :minor].reshape(shape)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Any tensor -> (lead, nb, BLOCK) int8 payload, (lead, nb, 1) fp32 scale."""
    return _quantize_leaf(_to_blocks(x.float()))


def _dequantize(payload: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return _from_blocks(_dequantize_leaf(payload, scale), shape)


@functools.lru_cache(maxsize=1024)
def bias_corrections(b1: float, b2: float, count: int) -> tuple[np.float32, np.float32]:
    """Adam's fp32 bias corrections (1 - b1^count, 1 - b2^count), the power
    of fp32 operands taken in fp64 and rounded to fp32: XLA's pow on the CPU
    rounds so (one miss in 6000 counts up to 3000), numpy's fp32 pow does
    not. Cached: every Adam group of a step asks for the same few."""
    c = np.float64(np.float32(count))

    def pow32(b):
        return np.float32(np.float64(np.float32(b)) ** c)

    return np.float32(1.0) - pow32(b1), np.float32(1.0) - pow32(b2)


def _min_8bit_size() -> int:
    return int(os.environ.get("SSDT_INT8_FUSED_MIN", 1 << 18))


def _stores_int8(shape, min_size: int) -> bool:
    """Whether a leaf's moments are stored int8 (else plain fp32), as the JAX
    package decides it: a leading dim, a bounded scale panel, and at least
    ``min_size`` elements."""
    lead, minor, nb = _leaf_view(shape)
    slab_ok = (lead + 256) * nb * 16 <= 64 * 1024 * 1024
    return lead > 1 and slab_ok and lead * minor >= min_size


def stack_member_view(stack_key: str, shape, n: int) -> tuple[int, int, int]:
    """(rows, minor, n_blocks) of one member of an int8 stack of ``n``
    leaves of ``shape``: its share of the stack's (lead, minor, n_blocks)
    view, whose lead n divides. Mostly the member's own view; where the
    stack merges its dims otherwise (a stack (3, 32, 32, 3, 3) is 3 rows of
    9216, a member alone 32 rows of 288), the stack's, so that each member
    owns whole rows of the stack's payloads and scales."""
    shape = tuple(int(d) for d in shape)
    lead, minor, nb = _leaf_view((n,) + shape)
    if lead % n:
        raise ValueError(f"{stack_key}: the int8 view of the stack {(n,) + shape} has {lead} "
                         f"rows, which its {n} members cannot share")
    return lead // n, minor, nb


def int8_views(shapes: Mapping[str, tuple], min_size: int,
               pack_spec=None) -> dict[str, tuple[int, int, int]]:
    """The (lead, minor, n_blocks) view of each key of ``shapes`` whose
    moments are stored int8. Without a pack spec each leaf decides by its
    own view (``_stores_int8``); with one, as the JAX trainer's packed run
    does: a slab's members never (a slab is 1-D), a stack's members when
    the stack is, each in its share of the stack's view
    (``stack_member_view``), the other leaves by their own view."""
    own = {k: _leaf_view(s) for k, s in shapes.items() if _stores_int8(s, min_size)}
    if pack_spec is None or not pack_spec.nontrivial:
        return own
    packed = pack_spec.packed_keys
    out = {k: v for k, v in own.items() if k not in packed}
    for stack_key, members, shape in pack_spec.stacks:
        if _stores_int8((len(members),) + tuple(shape), min_size):
            view = stack_member_view(stack_key, shape, len(members))
            out.update({k: view for k in members if k in shapes})
    return out


@dataclasses.dataclass
class Adam8bitState:
    count: int        # updates applied so far
    mu_q: Tensors     # int8 (lead, nb*256), or fp32 natural-shape moments
    mu_s: Tensors     # fp32 (lead, nb), int8 leaves only
    nu_q: Tensors
    nu_s: Tensors


@dataclasses.dataclass(frozen=True)
class Adam8bit:
    """scale_by_adam with int8 blockwise moment storage; the update comes
    out in each gradient's dtype."""
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Tensors, pack_spec=None) -> Adam8bitState:
        """Zero moments; ``pack_spec``: the JAX trainer's packing of the
        run, which decides the int8 leaves and their views as JAX does
        (``int8_views``)."""
        views = int8_views({k: tuple(p.shape) for k, p in params.items()}, _min_8bit_size(),
                           pack_spec)
        mu_q, mu_s = {}, {}
        for k, p in params.items():
            if k not in views:
                mu_q[k] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                continue
            lead, _, nb = views[k]
            mu_q[k] = torch.zeros(lead, nb * BLOCK, dtype=torch.int8, device=p.device)
            mu_s[k] = torch.zeros(lead, nb, dtype=torch.float32, device=p.device)
        return Adam8bitState(0, mu_q, mu_s, {k: v.clone() for k, v in mu_q.items()},
                             {k: v.clone() for k, v in mu_s.items()})

    def update(self, grads: Tensors, state: Adam8bitState) -> tuple[Tensors, Adam8bitState]:
        count = state.count + 1
        bc = bias_corrections(self.b1, self.b2, count)
        inv_bc1, inv_bc2 = (float(np.float32(1.0) / b) for b in bc)
        hp = dict(b1=self.b1, b2=self.b2, eps=self.eps)
        updates = {}
        for k in sorted(grads):
            g = grads[k]
            if k not in state.mu_s:
                updates[k] = adam_bf16_fused_update(
                    g.contiguous(), state.mu_q[k], state.nu_q[k], bc, out_dtype=g.dtype,
                    recip_bc=True, **hp)[0]
                continue
            lead = state.mu_s[k].shape[0]   # the leaf's view, or its share of a stack's
            out = adam8_fused_update(g.reshape(lead, -1).contiguous(), state.mu_q[k],
                                     state.mu_s[k], state.nu_q[k], state.nu_s[k], inv_bc1,
                                     inv_bc2, **hp)[0]
            updates[k] = out.view(g.shape)
        return updates, dataclasses.replace(state, count=count)

    def update_and_apply_int8(self, grads: Tensors, state: Adam8bitState, params: Tensors, *,
                              step: int, weight_decay: float, step_size: float,
                              tables: dict) -> None:
        """``update`` of the int8 leaves, then the decay, the schedule
        (``step_size``, in the update's dtype) and the master apply at train
        step ``step``, the masters in ``params`` and the int8 state updated
        in place: one launch over the group's int8 leaf table, cached in
        ``tables`` from call to call. The count and the fp32-moment leaves
        are the caller's."""
        keys8 = sorted(k for k in state.mu_s if k in params)
        if not keys8:
            return
        inv_bc1, inv_bc2 = (float(np.float32(1.0) / b)
                            for b in bias_corrections(self.b1, self.b2, state.count + 1))
        ps8 = [params[k] for k in keys8]
        st8 = [(state.mu_q[k], state.mu_s[k], state.nu_q[k], state.nu_s[k]) for k in keys8]
        t8 = tables.get("int8")
        if t8 is None or not t8.holds(keys8, ps8, st8):
            t8 = tables["int8"] = build_adam8_table(keys8, ps8, st8)
        adam8_fused_apply(t8, [grads[k] for k in keys8], inv_bc1, inv_bc2, b1=self.b1,
                          b2=self.b2, eps=self.eps, step=step, weight_decay=weight_decay,
                          step_size=step_size)
