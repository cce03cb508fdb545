"""The EMA update of the shadows, on Hopper: one launch of
``ops/csrc/ema_fused.cu`` over a leaf table (``build_ema_table``) that holds
every shadow of one (shadow dtype, master dtype) pair, so one launch per
step (``training/ema.py``), the design of the optimizers' grouped launches
(``ops/adam_bf16_fused.py``).

Not the port of a TPU kernel: the JAX package computes the EMA in XLA
(``ema_update`` in its ``training/ema.py``). Per element, in fp32 with each
operation rounded on its own: ``new = s - (1 - decay_t) * (s - p)``, stored
to a bf16 shadow by stochastic rounding with the train step's dither
(``ops/sr.py`` ``ema_dither``: the low half of the master store's hash for
bf16 masters, the high half of a hash salted ``EMA_SALT`` otherwise), to
an fp32 shadow as it is. Masters and shadows are fp32 or bf16. The masters are read as they stand in
stream order, so after the optimizer's launch: the updated masters.

``ema_fused_apply`` launches the kernel for a table on a card and runs its
plain version ``ema_fused_apply_reference`` (leaf by leaf) for one on the
CPU; neither falls back to the other. ``launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build
from .adam_bf16_fused import CHUNK, DTYPE_CODES, chunk_map, same_tensors
from .sr import EMA_SALT, MASTER_SALT, dither_seed, ema_dither, leaf_salt, stochastic_round_bf16_bits

launches = {"ema_fused": 0}
DTYPES = (torch.float32, torch.bfloat16)   # of masters and shadows, as the port keeps them


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# EmaLeaf of ops/csrc/ema_fused.cu
_LEAF = np.dtype([("shadow", "<u8"), ("master", "<u8"), ("n", "<i8"), ("salt", "<u4"),
                  ("pad", "<u4")])
assert _LEAF.itemsize == 32


@dataclasses.dataclass(eq=False)
class EMATable:
    """The leaf table of an EMA launch: its shadows and masters (the
    shadows updated in place, the masters read), each leaf's dither salt,
    the packed records and the chunk map; on a card also their device
    copies. Built once, reused while ``holds`` the same tensors."""
    keys: tuple[str, ...]
    shadows: list[torch.Tensor]
    masters: list[torch.Tensor]
    records: np.ndarray        # _LEAF per leaf
    chunks: np.ndarray         # (n_chunks, 2) int32 (leaf, chunk)
    device: torch.device
    dev_records: Optional[torch.Tensor] = None
    dev_chunks: Optional[torch.Tensor] = None

    def holds(self, keys: Sequence[str], shadows: Sequence[torch.Tensor],
              masters: Sequence[torch.Tensor]) -> bool:
        return (tuple(keys) == self.keys and same_tensors(shadows, self.shadows)
                and same_tensors(masters, self.masters))


def build_ema_table(keys: Sequence[str], shadows: Sequence[torch.Tensor],
                    masters: Sequence[torch.Tensor]) -> EMATable:
    """The EMA table of leaves ``keys``: shadows and their masters, each pair
    of one size, each fp32 or bf16. On a card every tensor must be
    contiguous, the shadows of one dtype and the masters of one dtype."""
    keys, shadows, masters = tuple(keys), list(shadows), list(masters)
    device = shadows[0].device if shadows else torch.device("cpu")
    for what, ts in (("shadow", shadows), ("master", masters)):
        for k, t, s in zip(keys, ts, shadows):
            if t.numel() != s.numel() or t.device != device:
                raise ValueError(f"ema_fused: {what} of {k} is {tuple(t.shape)} on {t.device}, "
                                 f"its shadow {tuple(s.shape)} on {device}")
            if t.dtype not in DTYPES:
                raise TypeError(f"ema_fused: {what} of {k} is {t.dtype}; masters and shadows "
                                f"are fp32 or bf16")
            if device.type == "cuda" and (not t.is_contiguous() or t.dtype != ts[0].dtype):
                raise ValueError(f"ema_fused: the {what} tensors of a table must be contiguous "
                                 f"and of one dtype; {k} is {t.dtype}")
    low = bool(masters) and masters[0].dtype == torch.bfloat16
    rec = np.zeros(len(keys), _LEAF)
    rec["shadow"] = [t.data_ptr() for t in shadows]
    rec["master"] = [t.data_ptr() for t in masters]
    rec["n"] = [t.numel() for t in shadows]
    rec["salt"] = [leaf_salt(k, MASTER_SALT if low else EMA_SALT) for k in keys]
    table = EMATable(keys, shadows, masters, rec,
                     chunk_map([max(1, -(-int(n) // CHUNK)) for n in rec["n"]]), device)
    if device.type == "cuda" and keys:
        table.dev_records = torch.from_numpy(rec.view(np.uint8)).to(device)
        table.dev_chunks = torch.from_numpy(table.chunks).to(device)
    return table


def ema_fused_apply_reference(table: EMATable, one_minus: float, step: int) -> None:
    """Plain version, leaf by leaf: ``s - one_minus * (s - p)`` in fp32, each
    operation rounded on its own, stored to the shadow in place (a bf16
    shadow by SR with ``ema_dither`` at ``step``)."""
    for k, s, p in zip(table.keys, table.shadows, table.masters):
        s32 = s.float()
        new = s32 - (s32 - p.float()) * s32.new_full((), one_minus)
        if s.dtype == torch.bfloat16:
            new = stochastic_round_bf16_bits(
                new, ema_dither(s.shape, step, k, p.dtype == torch.bfloat16, s.device))
        s.copy_(new)


def ema_fused_apply(table: EMATable, one_minus: float, step: int) -> None:
    """The EMA update of every leaf of ``table``, in one launch on a card;
    the shadows are updated in place. one_minus: ``1 - decay_t``, an fp32
    value; step: the train step before its increment (the dither's seed)."""
    if table.device.type != "cuda":
        ema_fused_apply_reference(table, one_minus, step)
        return
    if not table.keys:
        return
    s_dtype, p_dtype = table.shadows[0].dtype, table.masters[0].dtype
    lib = _build.load_library()
    with torch.cuda.device(table.device):
        err = lib.ssdt_ema_group(
            table.dev_records.data_ptr(), table.dev_chunks.data_ptr(), len(table.chunks),
            CHUNK, DTYPE_CODES[s_dtype], DTYPE_CODES[p_dtype], int(p_dtype == torch.bfloat16),
            ctypes.c_float(one_minus), dither_seed(step, 0),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "ema_fused", err)
    launches["ema_fused"] += 1
