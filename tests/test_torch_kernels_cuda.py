"""The port's CUDA kernels against their plain PyTorch versions, on a card:
splash attention, the fused Adam update and the int8 Adam update.

Skips without a CUDA card. Imports no JAX, so it also runs where JAX is not
installed; there, skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from scal_sdt_tpu_torch.ops import adam8_fused as A8
from scal_sdt_tpu_torch.ops import adam_bf16_fused as AF
from scal_sdt_tpu_torch.ops import splash as S


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 1024, 40), (1, 8, 1344, 40), (1, 4, 1100, 80),
                                   (1, 2, 1024, 64), (1, 2, 1030, 160)])
def test_kernels_match_reference_on_cuda(shape):
    """splash_attention (kernels, autograd) against autograd of the plain
    version, at the bounds of the JAX splash tests: forward 5e-3 max-abs,
    gradients 1.5e-2 relative."""
    if not torch.cuda.is_available():
        pytest.skip("the splash kernels run on a CUDA card only")
    r = np.random.RandomState(5)
    q, k, v, g = (torch.from_numpy(r.randn(*shape).astype(np.float32)).cuda().bfloat16()
                  for _ in range(4))
    scale = shape[-1] ** -0.5
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    refs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = S.splash_attention(*leaves, scale)
    want = S.splash_attention_reference(*refs, scale)
    out.backward(g)
    want.backward(g)
    assert float((out.float() - want.float()).abs().max()) < 5e-3
    for a, b in zip(leaves, refs):
        err = (a.grad.float() - b.grad.float()).abs().max() / b.grad.float().abs().max()
        assert float(err) < 1.5e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("the kernels run on a CUDA card only")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,g_dt,m_dt,out_dt,recip,sr", [
    ((1280, 2304), torch.bfloat16, torch.bfloat16, torch.float32, False, True),   # AdamW
    ((320,), torch.bfloat16, torch.float32, torch.bfloat16, True, False),        # int8 path
    ((77, 130), torch.float32, torch.float32, torch.float32, False, False),
    ((33, 17), torch.float32, torch.float16, torch.float16, True, True),
])
def test_adam_bf16_fused_matches_reference_on_cuda(shape, g_dt, m_dt, out_dt, recip, sr):
    """Moments bit for bit, the step within 1e-6 relative."""
    _need_card()
    r = np.random.RandomState(sum(shape))
    g = torch.from_numpy(r.randn(*shape).astype(np.float32) * 1e-3).cuda().to(g_dt)
    mu = torch.from_numpy(r.randn(*shape).astype(np.float32) * 1e-4).cuda().to(m_dt)
    nu = torch.from_numpy(np.abs(r.randn(*shape)).astype(np.float32) * 1e-7).cuda().to(m_dt)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, out_dtype=out_dt, recip_bc=recip,
              **({"sr_step": 7, "sr_salt": 0x1234ABCD} if sr else {}))
    bc = (np.float32(1) - np.float32(0.9) ** 7, np.float32(1) - np.float32(0.999) ** 7)
    want = AF.adam_bf16_fused_update_reference(g, mu.clone(), nu.clone(), bc, **kw)
    got = AF.adam_bf16_fused_update(g, mu, nu, bc, **kw)
    torch.cuda.synchronize()
    assert got[0].dtype == out_dt
    err = (got[0].float() - want[0].float()).abs().max() / want[0].float().abs().max()
    assert float(err) <= 1e-6
    assert got[1] is mu and got[2] is nu  # updated in place
    assert torch.equal(mu, want[1]) and torch.equal(nu, want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,zero", [((64, 256), False), ((64, 300), False),
                                        ((40, 432), False), ((70, 1024), False),
                                        ((32, 300), True)])
def test_adam8_fused_matches_reference_on_cuda(shape, zero):
    """Payloads at most 1 apart in under 1e-3 of them; scales and the step
    within 1e-6 relative; the padded tail stays zero."""
    _need_card()
    lead, minor = shape
    nb = -(-minor // A8.BLOCK)
    r = np.random.RandomState(sum(shape))
    g = torch.from_numpy(r.randn(*shape).astype(np.float32)).cuda().bfloat16()
    if zero:
        state = [torch.zeros(lead, nb * A8.BLOCK, dtype=torch.int8, device="cuda"),
                 torch.zeros(lead, nb, device="cuda")]
        state += [t.clone() for t in state]
    else:
        state = []
        for s in (0.1, 0.01):
            m = torch.from_numpy(np.abs(r.randn(lead, nb * A8.BLOCK)).astype(np.float32) * s)
            q, sc = A8.quantize_blocks(m.cuda().view(lead, nb, A8.BLOCK))
            state += [q.view(lead, -1).contiguous(), sc.view(lead, nb).contiguous()]
    inv = (1 / (1 - 0.9 ** 7), 1 / (1 - 0.999 ** 7))
    want = A8.adam8_fused_update_reference(g, *(t.clone() for t in state), *inv, b1=0.9,
                                           b2=0.999, eps=1e-8)
    got = A8.adam8_fused_update(g, *state, *inv, b1=0.9, b2=0.999, eps=1e-8)
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(got[1:], state))  # updated in place
    for name, a, b in zip(("out", "mu_q", "mu_s", "nu_q", "nu_s"), got, want):
        if name.endswith("_q"):
            d = (a.int() - b.int()).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3, name
            assert not a[:, minor:].any() or not zero, name
        else:
            err = (a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)
            assert float(err) <= 1e-6, name
