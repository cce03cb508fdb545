"""Counter-hash dither and bf16 stochastic rounding (port of the SR half of
``scal_sdt_tpu/training/ema.py``): the plain version of the SR stores that
``ops/csrc/adam_common.cuh`` computes in the optimizer kernels (nu, and the
master apply of the grouped entries), and of the master apply in
``training/step.py``. Each leaf's two salts live here, as ops and training
both need them: ``crc32(key) ^ NU_SALT`` for the bf16 nu store (dithered at
the optimizer's count) and ``crc32(key) ^ MASTER_SALT`` for the bf16 master
store (dithered at the train step). A bf16 EMA shadow (``ema_dither``) reads
the low half of the master store's hash where the master is bf16 (one hash,
two independent 16-bit streams), and the high half of a hash salted
``crc32(key) ^ EMA_SALT`` otherwise, both at the train step.

The bits match the JAX version exactly. torch has no general uint32
arithmetic, so the hash runs on int32 tensors holding the uint32 bit
patterns: add and multiply wrap the same way in two's complement, XOR is
bitwise, and each right shift is masked after the (arithmetic) shift so it
acts as a logical one.
"""

from __future__ import annotations

import math
import zlib

import torch

_U32 = 0xFFFFFFFF
NU_SALT = 0xE3A0003
MASTER_SALT = 0xE3A0001
EMA_SALT = 0xE3A0002


def leaf_salt(key: str, base: int) -> int:
    """A leaf's salt: ``crc32(key) ^ base`` (``base`` NU_SALT or MASTER_SALT)."""
    return zlib.crc32(key.encode()) ^ base


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


def ema_dither(shape, step: int, key: str, master_is_bf16: bool, device) -> torch.Tensor:
    """The 16 dither bits (int32 values in [0, 2^16)) of a bf16 EMA shadow's
    SR store of leaf ``key`` at train step ``step`` (the step before its
    increment): the low half of the master store's hash for a bf16 master,
    the high half of a hash salted ``EMA_SALT`` otherwise."""
    if master_is_bf16:
        return cheap_dither_u32(shape, step, leaf_salt(key, MASTER_SALT), device) & 0xFFFF
    return cheap_dither_u16(shape, step, leaf_salt(key, EMA_SALT), device)


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


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root in x's dtype, as a card's ``sqrtf``
    and XLA compute it: torch's vectorized CPU sqrt misses it by an ulp now
    and then (about 7e-3 of fp32 inputs), so on the CPU it runs in fp64 and
    rounds through fp32 (exact: fp64 has more than twice fp32's bits)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return x.double().sqrt().float().to(x.dtype)


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to fp32, as a card's ``fmaf`` and XLA's
    contracted multiply-adds compute it; operands are fp32 tensors or python
    floats (rounded to fp32 first). In fp64 the product is exact and the sum
    is rounded once; only where that rounded sum lies exactly halfway
    between two fp32 values could a second rounding go the wrong way, and
    there it is moved one fp64 ulp toward the exact sum (TwoSum's error
    term) first."""
    ref = next(t for t in (a, b, c) if torch.is_tensor(t))

    def f64(t):
        if torch.is_tensor(t):
            return t.float().double()
        return torch.tensor(float(torch.tensor(t, dtype=torch.float32)), dtype=torch.float64,
                            device=ref.device)

    a, b, c = f64(a), f64(b), f64(c)
    s = a * b
    t = s + c
    bb = t - s
    err = (s - (t - bb)) + (c - bb)
    r = t.float()
    inf = torch.full_like(r, math.inf)
    side = torch.nextafter(r, torch.where(t > r.double(), inf, -inf))
    tie = (t != r.double()) & (t == (r.double() + side.double()) * 0.5)
    toward = torch.where(err > 0, inf.double(), -inf.double())
    return torch.where(tie & (err != 0), torch.nextafter(t, toward).float(), r)


def apply_update_reference(p: torch.Tensor, u: torch.Tensor, step: int, salt: int
                           ) -> torch.Tensor:
    """A master plus its update, as a new tensor: bf16 masters add in fp32
    and round stochastically (dithered at ``step`` with ``salt``), other
    masters add the update cast to their dtype."""
    if p.dtype == torch.bfloat16:
        return stochastic_round_bf16_cheap(p.float() + u.float(), step, salt)
    return p + u.to(p.dtype)
