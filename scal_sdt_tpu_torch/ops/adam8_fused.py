"""Fused int8 blockwise Adam update on Hopper: the port of
``scal_sdt_tpu/ops/adam8_fused.py`` (``adam8_fused_update``).

The moments of a leaf are stored as int8 payloads with one fp32 absmax scale
per 256-element block of the leaf's (lead, minor) view (``training/
quantized.py``). One kernel launch per leaf (``ops/csrc/adam8_fused.cu``)
dequantizes both moments, runs Adam in fp32, writes
``mu*inv_bc1 / (sqrt(nu*inv_bc2) + eps)`` in the gradient's dtype and
requantizes both moments in place, so the fp32 moments never reach device
memory.

``adam8_fused_update`` launches the kernel for CUDA tensors and runs
``adam8_fused_update_reference`` (the plain PyTorch version, the unfused
leaf math of the JAX ``training/quantized.py``) for CPU tensors; it never
falls back from one to the other. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .adam_bf16_fused import DTYPE_CODES

BLOCK = 256

launches = {"adam8_fused": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def quantize_blocks(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., BLOCK) fp32 -> int8 payload + fp32 absmax scale per block
    (shape (..., 1)): scale = absmax / 127, payload = clip(round half to
    even(x / safe), -127, 127) with safe = scale where scale > 0, else 1."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
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
