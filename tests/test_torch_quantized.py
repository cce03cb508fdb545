"""The port's int8 Adam (training/quantized.py, ops/adam8_fused.py) against
the JAX package on the CPU.

* leaf views and the int8/fp32 split over every SD1.5 leaf: identical;
* the block quantize round trip: payloads identical (at most 1 apart in
  under 1e-3 of them), scales within 1e-6 relative;
* ``adam8_fused_update_reference`` against the JAX Pallas kernel in
  interpret mode, at the shapes of tests/test_adam8_fused.py and from a zero
  state: payloads as above, fp32 outputs and scales within rtol 1e-6;
* ``Adam8bit`` against ``scale_by_adam_8bit`` over three steps on a mix of
  int8 and fp32-moment leaves, each step from the JAX state carried across
  by ``convert.from_jax``: updates bit for bit, moments as above.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scal_sdt_tpu.models.unet import UNetConfig, unet_param_shapes
from scal_sdt_tpu.ops import adam8_fused as jfused
from scal_sdt_tpu.training import quantized as jq

from scal_sdt_tpu_torch.convert.from_jax import group_state_from_jax, params_from_jax
from scal_sdt_tpu_torch.ops import adam8_fused as tfused
from scal_sdt_tpu_torch.training import quantized as tq

from torch_port_helpers import to_np as _np, to_torch as _t

B1, B2, EPS = 0.9, 0.999, 1e-8


def _assert_payloads(got, want, what):
    got, want = _np(got).astype(np.int32), _np(want).astype(np.int32)
    assert got.shape == want.shape, what
    # a quotient at an exact .5 may round the other way
    assert np.abs(got - want).max() <= 1, what
    assert (got != want).mean() < 1e-3, what


def test_leaf_views_and_int8_split_match_jax(monkeypatch):
    monkeypatch.delenv("SSDT_INT8_FUSED_MIN", raising=False)
    shapes = unet_param_shapes(UNetConfig.sd15())
    assert tq._min_8bit_size() == jq._min_8bit_size() == 1 << 18
    int8 = []
    for k, s in shapes.items():
        assert tq._leaf_view(s) == jq._leaf_view(s), k
        stores = tq._stores_int8(s, tq._min_8bit_size())
        assert stores == jq._stores_int8(s, jq._min_8bit_size()), k
        if stores:
            int8.append(k)
    assert len(shapes) == 686
    assert len(int8) == 227
    assert sum(int(np.prod(shapes[k])) for k in int8) == 851_886_080
    # the largest leaf and a ragged one, as the kernel sees them
    assert tq._leaf_view((1280, 2560, 3, 3)) == (1280, 23040, 90)
    assert tq._leaf_view((320, 320, 3, 3)) == (320, 2880, 12)


@pytest.mark.parametrize("shape", [(64, 256), (64, 300), (40, 48, 3, 3), (7,), (3, 5),
                                   (2, 3, 40000)])
def test_quantize_round_trip_matches_jax(shape):
    r = np.random.RandomState(sum(shape))
    x = (r.randn(*shape) * 10.0 ** r.uniform(-3, 1, shape)).astype(np.float32)
    x.flat[0] = 0.0
    jqv, jsv = jq._quantize(jnp.asarray(x))
    tqv, tsv = tq._quantize(torch.from_numpy(x))
    assert tuple(tqv.shape) == jqv.shape and tqv.dtype == torch.int8
    _assert_payloads(tqv, jqv, f"payload {shape}")
    np.testing.assert_allclose(_np(tsv), _np(jsv), rtol=1e-6, atol=0)
    back = tq._dequantize(tqv, tsv, shape)
    np.testing.assert_allclose(_np(back), _np(jq._dequantize(jqv, jsv, shape)), rtol=1e-6,
                               atol=1e-30)
    # a round trip moves each value by at most half a quantization step
    step = np.repeat(_np(tsv).reshape(tqv.shape[0], -1), tq.BLOCK, axis=1)
    step = tq._from_blocks(torch.from_numpy(step), shape).numpy()
    assert (np.abs(_np(back) - x) <= 0.5 * step * (1 + 1e-6)).all()


def _state(shape, seed):
    """A (lead, nb*256) int8 state quantized from seeded moments, and g."""
    r = np.random.RandomState(seed)
    g = r.randn(*shape).astype(np.float32)
    mu_q3, mu_s3 = jq._quantize(jnp.asarray(0.1 * r.randn(*shape).astype(np.float32)))
    nu_q3, nu_s3 = jq._quantize(jnp.asarray(0.01 * np.abs(r.randn(*shape)).astype(np.float32)))
    lead, _, nb = jq._leaf_view(shape)
    return g, [np.asarray(a).reshape(lead, -1) for a in (mu_q3, mu_s3, nu_q3, nu_s3)]


def _both(g2, state, inv_bc1, inv_bc2):
    want = jfused.adam8_fused_update(
        jnp.asarray(g2), *(jnp.asarray(a) for a in state), jnp.float32(inv_bc1),
        jnp.float32(inv_bc2), b1=B1, b2=B2, eps=EPS, interpret=True)
    got = tfused.adam8_fused_update(_t(g2), *(_t(a) for a in state), float(inv_bc1),
                                    float(inv_bc2), b1=B1, b2=B2, eps=EPS)
    return got, want


def _assert_adam8(got, want, what):
    for name, a, b in zip(("out", "mu_q", "mu_s", "nu_q", "nu_s"), got, want):
        if name.endswith("_q"):
            _assert_payloads(a, b, f"{name} {what}")
        else:
            if name.endswith("_s"):
                assert a.dtype == torch.float32, name
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} {what}")


@pytest.mark.parametrize("shape", [(64, 256), (64, 300), (40, 48, 3, 3), (70, 1024)])
def test_adam8_reference_matches_pallas_kernel(shape):
    g, state = _state(shape, seed=sum(shape))
    lead, minor, _ = jq._leaf_view(shape)
    t = np.float32(7.0)
    inv_bc1 = np.float32(1.0) / (np.float32(1.0) - np.float32(B1) ** t)
    inv_bc2 = np.float32(1.0) / (np.float32(1.0) - np.float32(B2) ** t)
    got, want = _both(g.reshape(lead, minor), state, inv_bc1, inv_bc2)
    _assert_adam8(got, want, str(shape))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_adam8_reference_zero_state_first_step(dtype):
    """The first step from a zero state (scales 0: the safe divisor), with a
    ragged minor whose padded tail must stay exactly zero."""
    lead, minor = 32, 300
    g = np.linspace(-1, 1, lead * minor, dtype=np.float32).reshape(lead, minor)
    if dtype == "bfloat16":
        g = np.asarray(jnp.asarray(g, jnp.bfloat16))
    zq, zs = np.zeros((lead, 512), np.int8), np.zeros((lead, 2), np.float32)
    inv_bc1 = np.float32(1.0) / (np.float32(1.0) - np.float32(B1))
    inv_bc2 = np.float32(1.0) / (np.float32(1.0) - np.float32(B2))
    got, want = _both(g, [zq, zs, zq, zs], inv_bc1, inv_bc2)
    _assert_adam8(got, want, f"zero state {dtype}")
    assert got[0].dtype == _t(g).dtype
    assert np.isfinite(_np(got[0])).all()
    for q in (got[1], got[3]):
        assert not q[:, minor:].any()


def test_adam8bit_matches_jax_over_three_steps(monkeypatch):
    # leaves of 1024 elements and more take int8 moments, in both packages
    monkeypatch.setenv("SSDT_INT8_FUSED_MIN", "1024")
    shapes = {"a.weight": (64, 300), "b.weight": (40, 48, 3, 3), "c.bias": (64,),
              "d.weight": (8, 16)}
    r = np.random.RandomState(4)
    params = {k: jnp.asarray(r.randn(*s).astype(np.float32), jnp.bfloat16)
              for k, s in shapes.items()}
    jtx = jq.scale_by_adam_8bit(B1, B2, EPS)
    ttx = tq.Adam8bit(B1, B2, EPS)
    jstate = jtx.init(params)
    tstate = ttx.init(params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                      device="cpu"))
    assert set(tstate.mu_s) == set(jstate.mu_s) == {"a.weight", "b.weight"}
    for k in shapes:
        assert tuple(tstate.mu_q[k].shape) == jstate.mu_q[k].shape
        assert str(tstate.mu_q[k].dtype)[6:] == str(jstate.mu_q[k].dtype)
    for i in range(3):
        grads = {k: jnp.asarray((r.randn(*s) * 10.0 ** r.uniform(-3, 0, s)).astype(np.float32),
                                jnp.bfloat16) for k, s in shapes.items()}
        tstate = group_state_from_jax(jstate, device="cpu")
        ju, jstate = jtx.update(grads, jstate)
        tu, tstate = ttx.update({k: _t(v) for k, v in grads.items()}, tstate)
        assert tstate.count == int(jstate.count) == i + 1
        for k in shapes:
            assert tu[k].dtype == torch.bfloat16 and tuple(tu[k].shape) == shapes[k]
            np.testing.assert_array_equal(_np(tu[k]), _np(ju[k]), f"update {k} step {i}")
            for name in ("mu_q", "nu_q"):
                got, want = getattr(tstate, name)[k], getattr(jstate, name)[k]
                if k in jstate.mu_s:
                    _assert_payloads(got, want, f"{name} {k} step {i}")
                else:
                    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-30)
            for name in ("mu_s", "nu_s"):
                if k in jstate.mu_s:
                    np.testing.assert_allclose(_np(getattr(tstate, name)[k]),
                                               _np(getattr(jstate, name)[k]), rtol=1e-6)
