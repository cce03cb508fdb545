"""Seeded inputs: weights, caches and draws, made on the device.

Every seed the benchmark takes is a whole number up to a little over 2**31
(more than 32 signed bits); each use derives a 63-bit seed of its own from it
(``derive``), so two uses never share a stream.

Weights follow one rule for every model: a matrix or kernel is a normal draw
over the square root of its fan-in, a bias is zero, any other vector (a
norm's scale) is one; tables the configuration fixes (``fixed``) are taken
as given. All normal draws of a model come from one flat draw on the device
(one call), cut into leaves in sorted name order, each leaf in the dtype it
is served in. The reference draws the same again (same seed, device and
dtype give the same numbers).
"""

from __future__ import annotations

import hashlib
import math

import torch


def derive(seed: int, *what) -> int:
    """A 63-bit generator seed for the use ``what`` of the run seed ``seed``."""
    text = ":".join(str(x) for x in (int(seed),) + what)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def generator(seed: int, device, *what) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *what))


def make_weights(shapes: dict[str, tuple[int, ...]], seed: int, device, dtype: torch.dtype,
                 fixed: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
    """The leaves of ``shapes`` from ``seed``, in ``dtype`` on ``device``."""
    fixed = fixed or {}
    drawn = sorted(k for k, s in shapes.items()
                   if k not in fixed and not k.endswith(".bias") and len(s) > 1)
    sizes = [math.prod(shapes[k]) for k in drawn]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, "weights"),
                       device=device, dtype=torch.float32)
    out: dict[str, torch.Tensor] = {}
    offset = 0
    for k, n in zip(drawn, sizes):
        shape = shapes[k]
        fan_in = max(math.prod(shape[1:]), 1)
        out[k] = (flat[offset:offset + n].view(shape) / math.sqrt(fan_in)).to(dtype)
        offset += n
    del flat
    for k, shape in shapes.items():
        if k in fixed:
            out[k] = fixed[k].to(device=device, dtype=dtype)
        elif k not in out:
            fill = 0.0 if k.endswith(".bias") else 1.0
            out[k] = torch.full(shape, fill, device=device, dtype=dtype)
    return {k: out[k] for k in sorted(out)}
