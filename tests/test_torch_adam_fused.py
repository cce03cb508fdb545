"""The port's fused Adam update (ops/adam_bf16_fused.py) against the JAX
package on the CPU (the AdamW8bit train step that runs it is in
tests/test_torch_step.py).

* ``adam_bf16_fused_update_reference`` in the reciprocal form without SR
  against the lab kernel (``lab/micro_bf16_update.py``) in interpret mode:
  output within 1e-6 relative, moments identical (fp32) or within one bf16
  ulp (bf16);
* the reference in the divide form against ``scale_by_adam_low_memory``,
  with a bf16 nu stored by SR and with an fp32 nu: output within 2e-6
  relative, bf16 moments within one bf16 ulp, fp32 nu within 1e-6 relative.
"""

import ast
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scal_sdt_tpu.training import optimizers as jopt

from scal_sdt_tpu_torch.ops.adam_bf16_fused import adam_bf16_fused_update

from torch_port_helpers import assert_bf16_ulp, to_np as _np, to_torch as _t

B1, B2, EPS = 0.9, 0.999, 1e-8
LAB = Path(__file__).resolve().parents[1] / "lab" / "micro_bf16_update.py"


def _lab_kernel():
    """The lab module's kernel definitions alone: the module itself runs a
    full SD1.5 benchmark when imported, so only its imports of JAX and
    Pallas, its constants and its functions are executed."""
    tree = ast.parse(LAB.read_text())
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mod = node.module if isinstance(node, ast.ImportFrom) else node.names[0].name
            if (mod or "").split(".")[0] in ("jax", "functools"):
                keep.append(node)
        elif isinstance(node, ast.FunctionDef):
            keep.append(node)
        elif isinstance(node, ast.Assign) and all(
                isinstance(t, ast.Name) and t.id in ("COL_BLOCK", "_DEFAULT_ROWS")
                for t in node.targets):
            keep.append(node)
    ns: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(LAB), "exec"), ns)
    return ns


def _moments(r, shape, minor, dtype):
    """Seeded moments of a padded (lead, padded) layout, zero past minor."""
    mu = (0.1 * r.randn(*shape)).astype(np.float32)
    nu = (0.01 * np.abs(r.randn(*shape))).astype(np.float32)
    mu[:, minor:] = nu[:, minor:] = 0.0
    return jnp.asarray(mu, dtype), jnp.asarray(nu, dtype)


@pytest.mark.parametrize("shape,g_dtype,m_dtype", [
    ((64, 512), jnp.float32, jnp.float32),
    ((40, 700), jnp.bfloat16, jnp.bfloat16),     # ragged minor: the kernel masks
    ((16, 1030), jnp.bfloat16, jnp.float32),
])
def test_reference_matches_lab_kernel(shape, g_dtype, m_dtype):
    lab = _lab_kernel()
    r = np.random.RandomState(sum(shape))
    lead, minor = shape
    padded = lab["padded_minor"](minor)
    g = jnp.asarray(r.randn(*shape).astype(np.float32), g_dtype)
    mu, nu = _moments(r, (lead, padded), minor, m_dtype)
    t = np.float32(5.0)
    bc = (np.float32(1.0) - np.float32(B1) ** t, np.float32(1.0) - np.float32(B2) ** t)
    inv = [jnp.float32(np.float32(1.0) / b) for b in bc]
    out, mu_o, nu_o = lab["adam_bf16_fused_update"](g, mu, nu, *inv, b1=B1, b2=B2, eps=EPS,
                                                    interpret=True)
    tout, tmu, tnu = adam_bf16_fused_update(
        _t(g), _t(mu)[:, :minor].contiguous(), _t(nu)[:, :minor].contiguous(), bc, b1=B1,
        b2=B2, eps=EPS, out_dtype=_t(g).dtype, recip_bc=True)
    assert tout.dtype == _t(g).dtype and tmu.dtype == _t(mu).dtype
    # XLA contracts b*m + (1-b)*g into one fma, so where the two terms
    # cancel, a moment (and the step made from it) differs by an ulp of the
    # terms, not of the sum: each value is held to 1e-6 relative (one bf16
    # ulp when stored bf16) plus 1e-6 of the tensor's largest entry
    for what, got, want, dt in (("out", tout, out, g_dtype), ("mu", tmu, mu_o, m_dtype),
                                ("nu", tnu, nu_o, m_dtype)):
        got, want = _np(got), _np(want)[:, :minor]
        rel = 1e-6 if dt == jnp.float32 else 2.0 ** -7
        bound = rel * np.maximum(np.abs(got), np.abs(want)) + 1e-6 * np.abs(want).max()
        assert (np.abs(got - want) <= bound).all(), what
    # the zero tail of the lab kernel's padded moments stays exactly zero
    assert not _np(mu_o)[:, minor:].any() and not _np(nu_o)[:, minor:].any()


@pytest.mark.parametrize("nu_dtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "fp32"])
def test_reference_matches_scale_by_adam_low_memory(nu_dtype):
    """The AdamW path's form: divide by the bias corrections, fp32 output,
    bf16 mu; a bf16 nu stored by SR salted crc32(key) ^ 0xE3A0003, an fp32
    nu (moment_dtype "mixed") stored as it is."""
    r = np.random.RandomState(9)
    shapes = {"unet.a.weight": (48, 64), "unet.b.bias": (33,)}
    sr = nu_dtype == jnp.bfloat16
    jtx = jopt.scale_by_adam_low_memory(B1, B2, EPS, jnp.bfloat16, nu_dtype=nu_dtype)
    params = {k: jnp.zeros(s, jnp.bfloat16) for k, s in shapes.items()}
    jstate = jtx.init(params)
    for count in (1, 2, 3):
        grads = {k: jnp.asarray((r.randn(*s) * 10.0 ** r.uniform(-4, 0, s)).astype(np.float32),
                                jnp.bfloat16) for k, s in shapes.items()}
        mu_in = {k: _t(v) for k, v in jstate.mu.items()}
        nu_in = {k: _t(v) for k, v in jstate.nu.items()}
        ju, jstate = jtx.update(grads, jstate)
        c = np.float32(count)
        bc = (np.float32(1.0) - np.float32(B1) ** c, np.float32(1.0) - np.float32(B2) ** c)
        for k in shapes:
            out, mu, nu = adam_bf16_fused_update(
                _t(grads[k]), mu_in[k], nu_in[k], bc, b1=B1, b2=B2, eps=EPS,
                out_dtype=torch.float32, recip_bc=False,
                **({"sr_step": count, "sr_salt": zlib.crc32(k.encode()) ^ 0xE3A0003} if sr
                   else {}))
            assert mu is mu_in[k] and nu is nu_in[k]  # updated in place
            assert out.dtype == torch.float32 and nu.dtype == _t(jstate.nu[k]).dtype
            np.testing.assert_allclose(_np(out), _np(ju[k]), rtol=2e-6, atol=1e-12)
            assert_bf16_ulp(mu, jstate.mu[k], f"mu {k} step {count}")
            if sr:
                assert_bf16_ulp(nu, jstate.nu[k], f"nu {k} step {count}")
            else:
                np.testing.assert_allclose(_np(nu), _np(jstate.nu[k]), rtol=1e-6, atol=0,
                                           err_msg=f"nu {k} step {count}")


def test_sr_needs_step_and_salt():
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="sr_step and sr_salt"):
        adam_bf16_fused_update(z, z, z, (0.1, 0.001), b1=B1, b2=B2, eps=EPS,
                               out_dtype=torch.float32, recip_bc=False, sr_step=1)
