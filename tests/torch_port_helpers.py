"""Shared inputs and checks of the tests that hold the PyTorch port against
the JAX package (tests/test_torch_*.py)."""

import numpy as np
import torch

from scal_sdt_tpu_torch.convert.from_jax import params_from_jax


def rand_unet_params(shapes: dict, seed: int = 0, prefix: str = "") -> dict:
    """Seeded numpy parameters for a shape template: fan-in scaled weights,
    small random biases and norm scales near 1 (so no term is trivially
    zero). Both packages take the same arrays."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(".bias"):
            v = rng.randn(*shape) * 0.02
        elif len(shape) == 1:
            v = 1.0 + rng.randn(*shape) * 0.02
        else:
            v = rng.randn(*shape) / np.sqrt(max(int(np.prod(shape[1:])), 1))
        out[prefix + name] = v.astype(np.float32)
    return out


def to_np(x) -> np.ndarray:
    """numpy of a JAX array or torch tensor; bf16 widens exactly to fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def to_torch(x) -> torch.Tensor:
    """A CPU tensor of a JAX or numpy array, bf16 carried bit for bit."""
    return params_from_jax({"x": np.asarray(x)}, device="cpu")["x"]


def bf16_ulp(x) -> np.ndarray:
    """The bf16 spacing at |x|: 2^(e-7) for |x| in [2^e, 2^(e+1)), and the
    subnormal spacing 2^-133 below 2^-126."""
    m = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def assert_bf16_ulp(got, want, what: str = "", slack=0.0) -> None:
    """At most one bf16 ulp apart, the ulp of the larger magnitude, plus
    ``slack`` (absolute, per element)."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    bound = bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + slack
    bad = np.abs(got - want) > bound
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} differ by more than 1 ulp"
