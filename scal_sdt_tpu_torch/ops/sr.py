"""Counter-hash dither and bf16 stochastic rounding (port of the SR half of
``scal_sdt_tpu/training/ema.py``): the plain version of the SR store that
``ops/csrc/adam_common.cuh`` computes in the fused Adam kernel, and the SR of
the master apply in ``training/step.py``.

The bits match the JAX version exactly. torch has no general uint32
arithmetic, so the hash runs on int32 tensors holding the uint32 bit
patterns: add and multiply wrap the same way in two's complement, XOR is
bitwise, and each right shift is masked after the (arithmetic) shift so it
acts as a logical one.
"""

from __future__ import annotations

import math

import torch

_U32 = 0xFFFFFFFF


def _i32(v: int) -> int:
    """The int32 value with the bit pattern of uint32 ``v``."""
    v &= _U32
    return v - (1 << 32) if v >= (1 << 31) else v


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32-held uint32 patterns."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def _murmur_mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer (full avalanche) over uint32 patterns in int32."""
    x = x ^ _shr(x, 16)
    x = x * _i32(0x85EBCA6B)
    x = x ^ _shr(x, 13)
    x = x * _i32(0xC2B2AE35)
    x = x ^ _shr(x, 16)
    return x


def dither_seed(step: int, salt: int) -> int:
    """The uint32 seed the counter hash adds to each index's product."""
    return ((int(step) * 0x9E3779B9) & _U32) ^ (salt & _U32)


def cheap_dither_u32(shape, step: int, salt: int, device) -> torch.Tensor:
    """32 hash bits per element of (element index, step, salt), as int32
    tensor holding the uint32 patterns of the JAX ``cheap_dither_u32``."""
    n = math.prod(shape) if shape else 1
    seed = _i32(dither_seed(step, salt))
    i = torch.arange(max(n, 1), dtype=torch.int32, device=device)
    return _murmur_mix(i * _i32(2654435761) + seed).reshape(shape)


def cheap_dither_u16(shape, step: int, salt: int, device) -> torch.Tensor:
    """High 16 bits of :func:`cheap_dither_u32`, values in [0, 2^16) (int32)."""
    return _shr(cheap_dither_u32(shape, step, salt, device), 16)


def stochastic_round_bf16_bits(x: torch.Tensor, r16: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 by adding the dither bits (values < 2^16) to the fp32
    pattern and truncating the low half: unbiased, and an exact no-op on
    values already representable in bf16."""
    bits = x.float().contiguous().view(torch.int32)
    # arithmetic >> 16 leaves the high half sign-extended: exactly int16.
    return ((bits + r16) >> 16).to(torch.int16).view(torch.bfloat16)


def stochastic_round_bf16_cheap(x: torch.Tensor, step: int, salt: int) -> torch.Tensor:
    """fp32 -> bf16 stochastic rounding with the counter-hash dither,
    deterministic in (step, salt)."""
    return stochastic_round_bf16_bits(x, cheap_dither_u16(x.shape, step, salt, x.device))
