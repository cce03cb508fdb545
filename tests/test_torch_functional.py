"""Port primitives (scal_sdt_tpu_torch.models.functional) against the JAX
functions they port, on the same inputs, fp32 at rtol/atol 1e-4 (the
tolerance of test_primitives_vs_torch.py). JAX activations are NHWC, the
port's NCHW: the test converts at the boundary."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scal_sdt_tpu.models import functional as J
from scal_sdt_tpu_torch.models import functional as T

TOL = dict(rtol=1e-4, atol=1e-4)


def _rng():
    return np.random.RandomState(0)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _params(**arrays):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _linear():
    r = _rng()
    x = r.randn(2, 5, 12).astype(np.float32)
    pj, pt = _params(**{"l.weight": r.randn(7, 12).astype(np.float32),
                        "l.bias": r.randn(7).astype(np.float32)})
    return np.asarray(J.linear(pj, "l", jnp.asarray(x))), T.linear(pt, "l", torch.from_numpy(x)).numpy()


def _conv(stride, padding):
    def case():
        r = _rng()
        x = r.randn(2, 9, 9, 6).astype(np.float32)
        pj, pt = _params(**{"c.weight": r.randn(8, 6, 3, 3).astype(np.float32),
                            "c.bias": r.randn(8).astype(np.float32)})
        return (np.asarray(J.conv2d(pj, "c", jnp.asarray(x), stride, padding)),
                _nhwc(T.conv2d(pt, "c", _nchw(x), stride, padding)))
    return case


def _group_norm():
    r = _rng()
    x = (r.randn(2, 6, 6, 16) * 3 + 1).astype(np.float32)
    pj, pt = _params(**{"g.weight": r.randn(16).astype(np.float32),
                        "g.bias": r.randn(16).astype(np.float32)})
    return (np.asarray(J.group_norm(pj, "g", jnp.asarray(x), 4, 1e-6)),
            _nhwc(T.group_norm(pt, "g", _nchw(x), 4, 1e-6)))


def _layer_norm():
    r = _rng()
    x = (r.randn(2, 7, 24) * 2 - 1).astype(np.float32)
    pj, pt = _params(**{"n.weight": r.randn(24).astype(np.float32),
                        "n.bias": r.randn(24).astype(np.float32)})
    return np.asarray(J.layer_norm(pj, "n", jnp.asarray(x))), T.layer_norm(pt, "n", torch.from_numpy(x)).numpy()


def _act(name):
    def case():
        x = _rng().randn(4, 33).astype(np.float32) * 3
        return (np.asarray(getattr(J, name)(jnp.asarray(x))),
                getattr(T, name)(torch.from_numpy(x)).numpy())
    return case


def _timestep_embedding(dim, flip, shift):
    def case():
        t = np.array([0, 1, 17, 999], np.int32)
        return (np.asarray(J.timestep_embedding(jnp.asarray(t), dim, flip, shift)),
                T.timestep_embedding(torch.from_numpy(t.astype(np.int64)), dim, flip, shift).numpy())
    return case


CASES = {
    "linear": _linear,
    "conv3x3": _conv(1, 1),
    "conv3x3_stride2": _conv(2, 1),
    "conv_pad0": _conv(1, 0),
    "group_norm": _group_norm,
    "layer_norm": _layer_norm,
    "silu": _act("silu"),
    "gelu": _act("gelu"),
    "timestep_embedding": _timestep_embedding(32, True, 0.0),
    "timestep_embedding_odd_shift": _timestep_embedding(33, False, 1.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_primitive_matches_jax(name):
    want, got = CASES[name]()
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_lora_params_are_refused():
    p = {"l.weight": torch.zeros(3, 4), "l.lora_A": torch.zeros(1, 4)}
    with pytest.raises(NotImplementedError):
        T.linear(p, "l", torch.zeros(2, 4))


def test_bf16_norms_keep_fp32_statistics():
    """bf16 in, bf16 out, statistics in fp32: equal to the fp32 norm of the
    same bf16 values, rounded once."""
    x = torch.from_numpy(_rng().randn(2, 16, 4, 4).astype(np.float32) * 50 + 300).bfloat16()
    p = {"g.weight": torch.ones(16), "g.bias": torch.zeros(16)}
    got = T.group_norm(p, "g", x, 4)
    assert got.dtype == torch.bfloat16
    want = T.group_norm(p, "g", x.float(), 4).bfloat16()
    assert torch.equal(got, want)
