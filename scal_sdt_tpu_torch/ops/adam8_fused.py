"""Fused int8 blockwise Adam update on Hopper: the port of
``scal_sdt_tpu/ops/adam8_fused.py`` (``adam8_fused_update``).

The moments of a leaf are stored as int8 payloads with one fp32 absmax scale
per 256-element block of the leaf's (lead, minor) view (``training/
quantized.py``). The kernel (``ops/csrc/adam8_fused.cu``) dequantizes both
moments, runs Adam in fp32, forms ``mu*inv_bc1 / (sqrt(nu*inv_bc2) + eps)``
in the gradient's dtype and requantizes both moments in place, so the fp32
moments never reach device memory. Two entry points:

* ``adam8_fused_update``: one leaf, returns the step (what the TPU kernel
  computes);
* ``adam8_fused_apply``: every int8 leaf of a param group in one launch, over
  an ``Adam8Table`` (``build_adam8_table``): Adam, then the decay, the
  schedule and the master apply, the masters updated in place.

Each launches the kernel for CUDA tensors and runs its plain PyTorch version
(``*_reference``: the unfused leaf math of the JAX ``training/quantized.py``,
and for the grouped entry the optimizer's chain leaf by leaf) for CPU
tensors; neither falls back from one to the other. ``launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .adam_bf16_fused import (DTYPE_CODES, GradPointers, same_tensors, check_grads, chunk_map,
                              decay_and_schedule_reference)
from .sr import MASTER_SALT, apply_update_reference, dither_seed, leaf_salt

BLOCK = 256
# 256-blocks per CTA of the grouped launch: CHUNK_STEPS steps of 16 blocks,
# one per half-warp (picked by scripts/sweep_adam_chunks.py on an H100)
CHUNK_STEPS = 8
CHUNK_BLOCKS = 16 * CHUNK_STEPS

launches = {"adam8_fused": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def quantize_blocks(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., BLOCK) fp32 -> int8 payload + fp32 absmax scale per block
    (shape (..., 1)): scale = absmax / 127, payload = clip(round half to
    even(x / safe), -127, 127) with safe = scale where scale > 0, else 1."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    # by a 0-dim tensor: torch on CUDA multiplies by the reciprocal of a
    # python divisor, which is not the division the kernel computes
    scale = amax / amax.new_full((), 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blocks(payload: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return payload.float() * scale


def adam8_fused_update_reference(g2: torch.Tensor, mu_q: torch.Tensor, mu_s: torch.Tensor,
                                 nu_q: torch.Tensor, nu_s: torch.Tensor, inv_bc1: float,
                                 inv_bc2: float, *, b1: float, b2: float, eps: float):
    """Plain version: the gradient zero-padded to whole blocks, the moments
    dequantized, updated and requantized in separate fp32 steps, the state
    written back in place. Returns (out, mu_q, mu_s, nu_q, nu_s)."""
    lead, minor = g2.shape
    nb = mu_s.shape[1]
    g3 = F.pad(g2.float(), (0, nb * BLOCK - minor)).view(lead, nb, BLOCK)
    mu = dequantize_blocks(mu_q.view(lead, nb, BLOCK), mu_s.view(lead, nb, 1))
    nu = dequantize_blocks(nu_q.view(lead, nb, BLOCK), nu_s.view(lead, nb, 1))
    mu = mu * b1 + g3 * (1.0 - b1)
    nu = nu * b2 + (g3 * g3) * (1.0 - b2)
    out = (mu * inv_bc1) / (torch.sqrt(nu * inv_bc2) + eps)
    out = out.view(lead, nb * BLOCK)[:, :minor].to(g2.dtype)
    for val, q_old, s_old in ((mu, mu_q, mu_s), (nu, nu_q, nu_s)):
        q, s = quantize_blocks(val)
        q_old.copy_(q.view(lead, nb * BLOCK))
        s_old.copy_(s.view(lead, nb))
    return out, mu_q, mu_s, nu_q, nu_s


def _check(g2, mu_q, mu_s, nu_q, nu_s) -> tuple[int, int, int]:
    if g2.dim() != 2 or not g2.is_cuda or not g2.is_contiguous():
        raise ValueError(f"adam8_fused: g2 must be a contiguous 2-d CUDA tensor, got "
                         f"{tuple(g2.shape)} strides {g2.stride()} on {g2.device}")
    if g2.dtype not in DTYPE_CODES:
        raise TypeError(f"adam8_fused: gradient dtype {g2.dtype} is not supported")
    lead, minor = g2.shape
    nb = -(-minor // BLOCK)
    for name, t, dtype, shape in (("mu_q", mu_q, torch.int8, (lead, nb * BLOCK)),
                                  ("mu_s", mu_s, torch.float32, (lead, nb)),
                                  ("nu_q", nu_q, torch.int8, (lead, nb * BLOCK)),
                                  ("nu_s", nu_s, torch.float32, (lead, nb))):
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != g2.device):
            raise ValueError(f"adam8_fused: {name} must be contiguous {dtype} {shape} on "
                             f"{g2.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if lead * minor >= 2 ** 31:
        raise NotImplementedError(f"adam8_fused: a leaf of {lead * minor} elements")
    if mu_q.data_ptr() % 16 or nu_q.data_ptr() % 16:
        raise ValueError("adam8_fused: the payloads must be 16-byte aligned")
    return lead, minor, nb


def adam8_fused_update(g2: torch.Tensor, mu_q: torch.Tensor, mu_s: torch.Tensor,
                       nu_q: torch.Tensor, nu_s: torch.Tensor, inv_bc1: float, inv_bc2: float,
                       *, b1: float, b2: float, eps: float):
    """One fused Adam step over a leaf's 2-D view.

    g2: (lead, minor) gradient (fp32, bf16 or fp16; the update comes back in
    its dtype), the leaf with trailing dims merged and NOT padded; mu_q/nu_q:
    (lead, nb*256) int8 payloads; mu_s/nu_s: (lead, nb) fp32 scales,
    nb = ceil(minor/256); inv_bc1/inv_bc2: fp32 reciprocal bias corrections.
    The state tensors are updated in place. Returns (out, mu_q, mu_s, nu_q,
    nu_s)."""
    if not g2.is_cuda:
        return adam8_fused_update_reference(g2, mu_q, mu_s, nu_q, nu_s, inv_bc1, inv_bc2,
                                            b1=b1, b2=b2, eps=eps)
    lead, minor, nb = _check(g2, mu_q, mu_s, nu_q, nu_s)
    out = torch.empty_like(g2)
    if g2.numel() == 0:
        return out, mu_q, mu_s, nu_q, nu_s
    f32 = ctypes.c_float
    lib = _build.load_library()
    with torch.cuda.device(g2.device):
        err = lib.ssdt_adam8_fused(
            g2.data_ptr(), mu_q.data_ptr(), mu_s.data_ptr(), nu_q.data_ptr(), nu_s.data_ptr(),
            out.data_ptr(), lead, minor, nb, DTYPE_CODES[g2.dtype], f32(b1), f32(b2),
            f32(1.0 - b1), f32(1.0 - b2), f32(eps), f32(inv_bc1), f32(inv_bc2),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "adam8_fused", err)
    launches["adam8_fused"] += 1
    return out, mu_q, mu_s, nu_q, nu_s


# ---- the grouped entry ----------------------------------------------------------

# Adam8Leaf of ops/csrc/adam8_fused.cu
_LEAF = np.dtype([("p", "<u8"), ("mu_q", "<u8"), ("mu_s", "<u8"), ("nu_q", "<u8"),
                  ("nu_s", "<u8"), ("lead", "<i4"), ("minor", "<i4"), ("nb", "<i4"),
                  ("master_salt", "<u4"), ("pad", "<i8")])
assert _LEAF.itemsize == 64


@dataclasses.dataclass(eq=False)
class Adam8Table:
    """The leaf table of a param group's int8 leaves: masters, payloads and
    scales (the tensors the launch updates in place), each leaf's (lead,
    minor) view and master salt, the packed records and the chunk map; on a
    card also their device copies and the gradient-address array."""
    keys: tuple[str, ...]
    params: list[torch.Tensor]
    state: list[tuple[torch.Tensor, ...]]   # (mu_q, mu_s, nu_q, nu_s) per leaf
    views: list[tuple[int, int]]            # (lead, minor) per leaf
    master_salts: list[int]
    records: np.ndarray                     # _LEAF per leaf
    chunks: np.ndarray                      # (n_chunks, 2) int32 (leaf, chunk)
    device: torch.device
    dev_records: Optional[torch.Tensor] = None
    dev_chunks: Optional[torch.Tensor] = None
    grads: Optional[GradPointers] = None

    def holds(self, keys: Sequence[str], params: Sequence[torch.Tensor],
              state: Sequence[tuple[torch.Tensor, ...]]) -> bool:
        """Whether the table is of exactly these leaves and tensors."""
        return (tuple(keys) == self.keys and same_tensors(params, self.params)
                and len(state) == len(self.state)
                and all(same_tensors(a, b) for a, b in zip(state, self.state)))


def build_adam8_table(keys: Sequence[str], params: Sequence[torch.Tensor],
                      state: Sequence[tuple[torch.Tensor, ...]]) -> Adam8Table:
    """The leaf table of int8 leaves ``keys``: masters ``params`` and, per
    leaf, (mu_q, mu_s, nu_q, nu_s) as ``training/quantized.py`` lays them
    out: payloads (lead, nb*256) int8, scales (lead, nb) fp32."""
    keys, params = tuple(keys), list(params)
    state = [tuple(s) for s in state]
    device = params[0].device if params else torch.device("cpu")
    views = []
    for k, p, (mu_q, mu_s, nu_q, nu_s) in zip(keys, params, state):
        lead, nb = mu_s.shape
        minor = p.numel() // lead
        for name, t, dtype, shape in (("mu_q", mu_q, torch.int8, (lead, nb * BLOCK)),
                                      ("mu_s", mu_s, torch.float32, (lead, nb)),
                                      ("nu_q", nu_q, torch.int8, (lead, nb * BLOCK)),
                                      ("nu_s", nu_s, torch.float32, (lead, nb))):
            if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                    or t.device != device):
                raise ValueError(f"adam8_fused: {name} of {k} must be contiguous {dtype} "
                                 f"{shape} on {device}, got {t.dtype} {tuple(t.shape)}")
        if lead * minor != p.numel() or -(-minor // BLOCK) != nb or lead * minor >= 2 ** 31:
            raise ValueError(f"adam8_fused: {k} of {tuple(p.shape)} does not fit its state "
                             f"of {lead} x {nb} blocks")
        if device.type == "cuda":
            if p.dtype not in DTYPE_CODES or p.dtype != params[0].dtype or not p.is_contiguous():
                raise ValueError(f"adam8_fused: the masters of a group must be contiguous and "
                                 f"of one dtype; {k} is {p.dtype}")
            if mu_q.data_ptr() % 16 or nu_q.data_ptr() % 16:
                raise ValueError(f"adam8_fused: the payloads of {k} must be 16-byte aligned")
        views.append((lead, minor))
    rec = np.zeros(len(keys), _LEAF)
    for field, i in (("mu_q", 0), ("mu_s", 1), ("nu_q", 2), ("nu_s", 3)):
        rec[field] = [s[i].data_ptr() for s in state]
    rec["p"] = [t.data_ptr() for t in params]
    rec["lead"] = [v[0] for v in views]
    rec["minor"] = [v[1] for v in views]
    rec["nb"] = [s[1].shape[1] for s in state]
    rec["master_salt"] = [leaf_salt(k, MASTER_SALT) for k in keys]
    counts = [max(1, -(-lead * int(nb) // CHUNK_BLOCKS))
              for (lead, _), nb in zip(views, rec["nb"])]
    table = Adam8Table(keys, params, state, views, rec["master_salt"].tolist(), rec,
                       chunk_map(counts), device)
    if device.type == "cuda" and keys:
        table.dev_records = torch.from_numpy(rec.view(np.uint8)).to(device)
        table.dev_chunks = torch.from_numpy(table.chunks).to(device)
        table.grads = GradPointers(len(keys), device)
    return table


def adam8_fused_apply_reference(table: Adam8Table, grads: Sequence[torch.Tensor],
                                inv_bc1: float, inv_bc2: float, *, b1: float, b2: float,
                                eps: float, step: int, weight_decay: float,
                                step_size: float) -> None:
    """Plain version: the optimizer's chain leaf by leaf -- the int8 Adam
    step in the gradient's dtype, decay and schedule, then the master apply
    at ``step`` -- with the masters and the int8 state updated in place."""
    for i, g in enumerate(grads):
        p = table.params[i]
        out = adam8_fused_update_reference(g.reshape(table.views[i]).contiguous(),
                                           *table.state[i], inv_bc1, inv_bc2, b1=b1, b2=b2,
                                           eps=eps)[0]
        u = decay_and_schedule_reference(out.view(p.shape), p, weight_decay, step_size)
        p.copy_(apply_update_reference(p, u, step, table.master_salts[i]))


def adam8_fused_apply(table: Adam8Table, grads: Sequence[torch.Tensor], inv_bc1: float,
                      inv_bc2: float, *, b1: float, b2: float, eps: float, step: int,
                      weight_decay: float, step_size: float) -> None:
    """One int8 Adam step and master apply over every leaf of ``table``, in
    one launch on a card; masters and state are updated in place.

    grads: one per leaf, in the table's order, any shape of the leaf's size;
    the update takes the gradients' dtype. inv_bc1/inv_bc2: fp32 reciprocal
    bias corrections; ``step``: the train step (the master SR's seed);
    step_size: ``-lr * schedule``."""
    kw = dict(b1=b1, b2=b2, eps=eps, step=step, weight_decay=weight_decay,
              step_size=step_size)
    if table.device.type != "cuda":
        adam8_fused_apply_reference(table, grads, inv_bc1, inv_bc2, **kw)
        return
    if not table.keys:
        return
    gs, g_dtype = check_grads("adam8_fused", grads, [t.numel() for t in table.params],
                              table.device)
    p_dtype = table.params[0].dtype
    wd_p = torch.full((), weight_decay, dtype=p_dtype).item()
    step_u = torch.full((), step_size, dtype=g_dtype).item()
    f32 = ctypes.c_float
    lib = _build.load_library()
    with torch.cuda.device(table.device):
        err = lib.ssdt_adam8_group(
            table.dev_records.data_ptr(), table.grads.upload(gs), table.dev_chunks.data_ptr(),
            len(table.chunks), CHUNK_STEPS, DTYPE_CODES[g_dtype], DTYPE_CODES[p_dtype],
            DTYPE_CODES[g_dtype], f32(b1), f32(b2), f32(1.0 - b1), f32(1.0 - b2), f32(eps),
            f32(inv_bc1), f32(inv_bc2), int(bool(weight_decay)), f32(wd_p), f32(step_u),
            dither_seed(step, 0), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "adam8_fused", err)
    launches["adam8_fused"] += 1
