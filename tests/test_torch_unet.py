"""Port UNet (scal_sdt_tpu_torch.models.unet) against the JAX ``unet_apply``
on the CPU: the same parameter dict (converted with params_from_jax), the
same inputs (NHWC for JAX, NCHW for the port), fp32, relative error < 1e-3
(the bound of test_full_model_parity.py). The four remat modes must give
identical outputs and gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scal_sdt_tpu.models import unet as J
from scal_sdt_tpu_torch.convert.from_jax import params_from_jax, params_to_numpy
from scal_sdt_tpu_torch.models import unet as T

from torch_port_helpers import rand_unet_params


@pytest.fixture(scope="module")
def tiny():
    params = rand_unet_params(J.unet_param_shapes(J.UNetConfig.tiny()))
    r = np.random.RandomState(1)
    sample = r.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([7, 421], np.int32)
    ctx = r.randn(2, 11, 32).astype(np.float32)
    return params, sample, t, ctx


@pytest.mark.parametrize("name", ["tiny", "sd15"])
def test_param_shapes_match_jax(name):
    assert T.unet_param_shapes(getattr(T.UNetConfig, name)()) == \
        J.unet_param_shapes(getattr(J.UNetConfig, name)())


def test_unet_forward_matches_jax(tiny):
    params, sample, t, ctx = tiny
    apply = jax.jit(lambda p, x, t, c: J.unet_apply(p, x, t, c, J.UNetConfig.tiny()))
    want = np.asarray(apply({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx)))
    got = T.unet_apply(params_from_jax(params, device="cpu"),
                       torch.from_numpy(sample).permute(0, 3, 1, 2),
                       torch.from_numpy(t.astype(np.int64)), torch.from_numpy(ctx),
                       T.UNetConfig.tiny()).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-3


def _forward_backward(params_np, sample, t, ctx, remat):
    p = {k: v.requires_grad_(True) for k, v in params_from_jax(params_np, device="cpu").items()}
    out = T.unet_apply(p, torch.from_numpy(sample).permute(0, 3, 1, 2),
                       torch.from_numpy(t.astype(np.int64)), torch.from_numpy(ctx),
                       T.UNetConfig.tiny(), remat=remat)
    out.square().mean().backward()
    return out.detach(), {k: v.grad for k, v in p.items()}


@pytest.mark.parametrize("remat", [True, "high", "top"])
def test_remat_modes_are_identical(tiny, remat):
    out0, grads0 = _forward_backward(*tiny, remat=False)
    out1, grads1 = _forward_backward(*tiny, remat=remat)
    assert torch.equal(out0, out1)
    assert grads0.keys() == grads1.keys()
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]), k


def test_params_round_trip_bf16():
    """bf16 arrays from JAX (ml_dtypes) cross bit for bit."""
    x = jnp.asarray(np.random.RandomState(2).randn(5, 3), jnp.bfloat16)
    t = params_from_jax({"w": np.asarray(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), np.asarray(x).view(np.int16))
    assert np.array_equal(params_to_numpy({"w": t})["w"], np.asarray(x.astype(jnp.float32)))


def test_init_is_seeded():
    a = T.init_unet_params(T.UNetConfig.tiny(), seed=3, device="cpu")
    b = T.init_unet_params(T.UNetConfig.tiny(), seed=3, device="cpu")
    assert a.keys() == set(T.unet_param_shapes(T.UNetConfig.tiny()))
    assert all(torch.equal(a[k], b[k]) for k in a)
