"""Shared inputs of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py)."""

import numpy as np


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
