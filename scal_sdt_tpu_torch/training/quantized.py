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

``Adam8bit.update`` runs the int8 leaves through ``ops/adam8_fused.py`` and
the fp32-moment leaves through ``ops/adam_bf16_fused.py`` (reciprocal bias
corrections, output in the gradient's dtype, nu rounded to nearest), one
launch per leaf on the card and the plain versions on the CPU. The state is
updated in place.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.adam8_fused import (BLOCK, adam8_fused_update, dequantize_blocks as _dequantize_leaf,
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


def _min_8bit_size() -> int:
    return int(os.environ.get("SSDT_INT8_FUSED_MIN", 1 << 18))


def _stores_int8(shape, min_size: int) -> bool:
    """Whether a leaf's moments are stored int8 (else plain fp32), as the JAX
    package decides it: a leading dim, a bounded scale panel, and at least
    ``min_size`` elements."""
    lead, minor, nb = _leaf_view(shape)
    slab_ok = (lead + 256) * nb * 16 <= 64 * 1024 * 1024
    return lead > 1 and slab_ok and lead * minor >= min_size


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

    def init(self, params: Tensors) -> Adam8bitState:
        min_size = _min_8bit_size()
        mu_q, mu_s = {}, {}
        for k, p in params.items():
            if not _stores_int8(p.shape, min_size):
                mu_q[k] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                continue
            lead, _, nb = _leaf_view(p.shape)
            mu_q[k] = torch.zeros(lead, nb * BLOCK, dtype=torch.int8, device=p.device)
            mu_s[k] = torch.zeros(lead, nb, dtype=torch.float32, device=p.device)
        return Adam8bitState(0, mu_q, mu_s, {k: v.clone() for k, v in mu_q.items()},
                             {k: v.clone() for k, v in mu_s.items()})

    def update(self, grads: Tensors, state: Adam8bitState) -> tuple[Tensors, Adam8bitState]:
        count = state.count + 1
        c = np.float32(count)
        bc = (np.float32(1.0) - np.float32(self.b1) ** c,
              np.float32(1.0) - np.float32(self.b2) ** c)
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
            lead, minor, _ = _leaf_view(g.shape)
            out = adam8_fused_update(g.reshape(lead, minor).contiguous(), state.mu_q[k],
                                     state.mu_s[k], state.nu_q[k], state.nu_s[k], inv_bc1,
                                     inv_bc2, **hp)[0]
            updates[k] = out.view(g.shape)
        return updates, dataclasses.replace(state, count=count)
