"""Fused Adam update over stored moments, on Hopper: the port of the TPU
kernel in ``lab/micro_bf16_update.py`` (``adam_bf16_fused_update``).

One launch per leaf reads the gradient and both moments in their storage
dtypes, runs Adam in fp32 and writes the bias-corrected step in
``out_dtype`` and the moments back (``ops/csrc/adam_bf16_fused.cu``). Two
switches make one kernel compute each caller's chain exactly:

* ``recip_bc``: multiply by the fp32 reciprocals of the bias corrections
  ``bc = (1 - b1^t, 1 - b2^t)`` (the lab kernel; the int8 path's fp32-moment
  leaves), or divide by them (``scale_by_adam_low_memory``, the AdamW path);
* ``sr_step`` / ``sr_salt``: store nu by the counter-hash stochastic rounding
  to bf16 (``ops/sr.py``) instead of rounding to nearest.

Both versions update mu and nu in place. ``adam_bf16_fused_update`` launches
the kernel for CUDA tensors and runs ``adam_bf16_fused_update_reference``
(the plain PyTorch chain) for CPU tensors; it never falls back from one to
the other. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build
from .sr import dither_seed, stochastic_round_bf16_cheap

# Storage dtypes the kernel reads and writes, by the code it takes.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

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


def adam_bf16_fused_update_reference(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                                     bc, *, b1: float, b2: float, eps: float,
                                     out_dtype: torch.dtype, recip_bc: bool,
                                     sr_step: Optional[int] = None,
                                     sr_salt: Optional[int] = None
                                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: (out, mu, nu), every operation rounded to fp32 on its
    own; mu stored rounded to nearest, nu by SR when ``sr_step`` is given."""
    c1, c2 = _factors(bc, recip_bc)
    g32 = g.float()
    m = mu.float() * b1 + g32 * (1.0 - b1)
    v = nu.float() * b2 + (g32 * g32) * (1.0 - b2)
    if recip_bc:
        out = (m * c1) / (torch.sqrt(v * c2) + eps)
    else:
        out = (m / c1) / (torch.sqrt(v / c2) + eps)
    mu.copy_(m)
    nu.copy_(v if sr_step is None else stochastic_round_bf16_cheap(v, sr_step, sr_salt))
    return out.to(out_dtype), mu, nu


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
                           sr_salt: Optional[int] = None
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step over a leaf: (out in ``out_dtype``, mu, nu), the
    moments updated in place.

    g, mu, nu: tensors of one shape, each fp32, bf16 or fp16 (the moments in
    their storage dtype). bc: the fp32 bias corrections (1 - b1^t, 1 - b2^t)."""
    if (sr_step is None) != (sr_salt is None):
        raise ValueError("adam_bf16_fused: give both sr_step and sr_salt, or neither")
    if not g.is_cuda:
        return adam_bf16_fused_update_reference(
            g, mu, nu, bc, b1=b1, b2=b2, eps=eps, out_dtype=out_dtype, recip_bc=recip_bc,
            sr_step=sr_step, sr_salt=sr_salt)
    _check(g, mu, nu, out_dtype)
    out = torch.empty(g.shape, dtype=out_dtype, device=g.device)
    if g.numel() == 0:
        return out, mu, nu
    c1, c2 = _factors(bc, recip_bc)
    sr = sr_step is not None
    seed = dither_seed(sr_step, sr_salt) if sr else 0
    f32 = ctypes.c_float
    lib = _build.load_library()
    with torch.cuda.device(g.device):
        err = lib.ssdt_adam_bf16_fused(
            g.data_ptr(), mu.data_ptr(), nu.data_ptr(), out.data_ptr(), g.numel(),
            DTYPE_CODES[g.dtype], DTYPE_CODES[mu.dtype],
            DTYPE_CODES[nu.dtype], DTYPE_CODES[out_dtype], f32(b1), f32(b2), f32(1.0 - b1),
            f32(1.0 - b2), f32(eps), f32(c1), f32(c2), int(recip_bc), int(sr), seed,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "adam_bf16_fused", err)
    launches["adam_bf16_fused"] += 1
    return out, mu, nu
