"""Port attention (scal_sdt_tpu_torch.ops) against the JAX package on the CPU.

``splash_attention_reference`` is the plain version of the CUDA splash
kernels; here it is held to ``_attention_xla`` and to ``jax.grad`` of it:
fp32 at 1e-4, bf16 at 5e-3 max-abs forward and 1.5e-2 relative gradients
(the bounds of the JAX splash tests, tests/test_splash_attention.py). The
kernels themselves run on the card only (chip_smoke.py and
tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scal_sdt_tpu.ops.attention import _attention_xla
from scal_sdt_tpu.ops.splash import pick_block as jax_pick_block
from scal_sdt_tpu_torch.ops import attention as A
from scal_sdt_tpu_torch.ops import splash as S

SHAPES = [(2, 2, 256, 40), (1, 2, 256, 80)]


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(*shape).astype(np.float32) for _ in range(4)]  # q, k, v, cotangent


def _jax_ref(q, k, v, g, dtype):
    scale = q.shape[-1] ** -0.5

    def f(q, k, v):
        return _attention_xla(q, k, v, scale).astype(jnp.float32)

    qj, kj, vj = (jnp.asarray(x, dtype) for x in (q, k, v))
    out, vjp = jax.vjp(f, qj, kj, vj)
    grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(x.astype(jnp.float32)) for x in grads]


def _port_ref(q, k, v, g, dtype):
    scale = q.shape[-1] ** -0.5
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    out = S.splash_attention_reference(qt, kt, vt, scale).float()
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.float().numpy() for t in (qt, kt, vt)]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_fp32(shape):
    q, k, v, g = _inputs(shape)
    out_j, grads_j = _jax_ref(q, k, v, g, jnp.float32)
    out_t, grads_t = _port_ref(q, k, v, g, torch.float32)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-4)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_bf16(shape):
    q, k, v, g = _inputs(shape, seed=1)
    out_j, grads_j = _jax_ref(q, k, v, g, jnp.bfloat16)
    out_t, grads_t = _port_ref(q, k, v, g, torch.bfloat16)
    assert float(np.abs(out_t - out_j).max()) < 5e-3
    for gt, gj in zip(grads_t, grads_j):
        assert _rel(gt, gj) < 1.5e-2


@pytest.mark.parametrize("shape", SHAPES + [(1, 2, 200, 40)])
def test_plain_kernel_passes_match_jax_grads(shape):
    """The plain versions of the three kernels (fwd, dq with delta, dkv),
    chained as the autograd Function chains the kernels, against jax.vjp."""
    q, k, v, g = _inputs(shape, seed=6)
    out_j, (dq_j, dk_j, dv_j) = _jax_ref(q, k, v, g, jnp.float32)
    scale = shape[-1] ** -0.5
    qs = S._prescale(torch.from_numpy(q), scale)
    kt, vt, do = (torch.from_numpy(x) for x in (k, v, g))
    o, lse = S.splash_fwd_reference(qs, kt, vt)
    dqs, delta = S.splash_dq_reference(qs, kt, vt, o, do, lse)
    dk, dv = S.splash_dkv_reference(qs, kt, vt, do, lse, delta)
    for got, want in ((o, out_j), (S._prescale(dqs, scale), dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_splash_on_cpu_is_the_reference():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs((1, 2, 128, 40)))
    before = dict(S.launches)
    got = S.splash_attention(q, k, v, 40 ** -0.5)
    assert torch.equal(got, S.splash_attention_reference(q, k, v, 40 ** -0.5))
    assert S.launches == before


@pytest.mark.parametrize("wrapper", ["splash_fwd", "splash_dq", "splash_dkv"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """A kernel wrapper launches on CUDA tensors or raises; it never computes
    on the CPU itself (that is splash_attention's plain path)."""
    t = torch.zeros(1, 2, 64, 40, dtype=torch.bfloat16)
    rows = torch.zeros(1, 2, 64)
    args = {"splash_fwd": (t, t, t), "splash_dq": (t, t, t, t, t, rows),
            "splash_dkv": (t, t, t, t, rows, rows)}[wrapper]
    with pytest.raises(TypeError, match="CUDA"):
        getattr(S, wrapper)(*args)


@pytest.mark.parametrize("lq,lk,causal", [(1024, 1024, False), (1024, 77, False),
                                          (1024, 1024, True), (64, 64, False)])
def test_dispatch_on_cpu_takes_no_kernel(lq, lk, causal):
    """The gate only opens on CUDA tensors: on the CPU every shape, the
    kernel-sized ones included, is the math path."""
    r = np.random.RandomState(2)
    qh = torch.from_numpy(r.randn(1, 2, lq, 40).astype(np.float32))
    kh, vh = (torch.from_numpy(r.randn(1, 2, lk, 40).astype(np.float32)) for _ in range(2))
    before = dict(S.launches)
    got = A._dispatch(qh, kh, vh, 0.25, causal)
    mask = A._causal_mask(lq, lk, qh.device) if causal else None
    assert torch.equal(got, A._attention_math(qh, kh, vh, 0.25, mask))
    assert S.launches == before


BF16 = torch.bfloat16


@pytest.mark.parametrize("q_shape,k_shape,dtype,causal,is_cuda,want", [
    ((8, 8, 4096, 40), (8, 8, 4096, 40), BF16, False, True, True),      # SD1.5, level 0
    ((8, 8, 4096, 160), (8, 8, 4096, 160), BF16, False, True, True),    # the widest kernel D
    ((1, 2, 4096, 168), (1, 2, 4096, 168), BF16, False, True, False),   # 161-256: math path
    ((1, 2, 4096, 200), (1, 2, 4096, 200), BF16, False, True, False),
    ((1, 2, 4096, 256), (1, 2, 4096, 256), BF16, False, True, False),
    ((1, 2, 4096, 44), (1, 2, 4096, 44), BF16, False, True, False),     # D % 8 != 0
    ((4096, 16, 1024, 40), (4096, 16, 1024, 40), BF16, False, True, False),  # B*H = 65536
    ((4095, 16, 1024, 40), (4095, 16, 1024, 40), BF16, False, True, True),   # B*H = 65520
    ((8, 1, 4096, 512), (8, 1, 4096, 512), BF16, False, True, False),   # VAE mid-block
    ((8, 12, 77, 64), (8, 12, 77, 64), BF16, True, True, False),        # CLIP, causal
    ((8, 8, 4096, 40), (8, 8, 77, 40), BF16, False, True, False),       # cross-attention
    ((8, 8, 4096, 40), (8, 8, 4096, 40), torch.float32, False, True, False),  # fp32 compute
    ((8, 8, 4096, 40), (8, 8, 4096, 40), BF16, False, False, False),    # CPU tensors
])
def test_gate_sends_the_kernels_only_what_they_take(q_shape, k_shape, dtype, causal, is_cuda,
                                                    want):
    """The gate as a pure function of (shapes, dtype, causal, is_cuda): every
    call it opens for, the kernels' own check accepts; a head dim of 161-256
    or one that is not a multiple of 8, a grid past 65535 rows, fp32 and
    causal calls take the math path instead of raising."""
    assert A.use_kernel(q_shape, k_shape, dtype, causal, is_cuda) is want
    assert S.kernel_accepts(q_shape, dtype) is (q_shape[3] % 8 == 0 and q_shape[3] <= 160
                                                and q_shape[0] * q_shape[1] <= 65535
                                                and dtype == BF16)


def test_causal_math_matches_jax():
    q, k, v, _ = _inputs((1, 2, 16, 8), seed=3)
    lq = lk = 16
    mask = jnp.where(np.tril(np.ones((lq, lk), bool)), 0.0, -jnp.inf)[None, None]
    want = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, mask))
    got = A._dispatch(*(torch.from_numpy(x) for x in (q, k, v)), 0.3, True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_multi_head_attention_shapes_and_views():
    r = np.random.RandomState(4)
    q = torch.from_numpy(r.randn(2, 64, 32).astype(np.float32))
    kv = torch.from_numpy(r.randn(2, 7, 32).astype(np.float32))
    qh = A._split_heads(q, 4)
    assert qh.shape == (2, 4, 64, 8) and qh.data_ptr() == q.data_ptr()  # a view
    assert torch.equal(A._merge_heads(qh), q)
    assert A.multi_head_attention(q, kv, kv, 4).shape == (2, 64, 32)


@pytest.mark.parametrize("length,preferred", [(4096, 1024), (1024, 1024), (2048, 512),
                                              (4032, 1024), (4480, 512), (1344, 512),
                                              (384, 512), (100, 512), (3072, 768)])
def test_pick_block_matches_jax(length, preferred):
    assert S.pick_block(length, preferred) == jax_pick_block(length, preferred)
