"""The port's CUDA kernels against their plain PyTorch versions, on a card:
splash attention (end to end, and the forward, dq and dkv kernels alone, one
head dim per compiled instance, with a second launch equal bit for bit), the fused Adam
update and the int8 Adam update, each in its single-leaf update-only form
and its grouped form (the fused Adam also in its ``xla`` rounding mode) (Adam, decay, schedule and master apply over a leaf
table in one launch; with bf16 gradients, and with the fp32 gradients of
gradient accumulation; the fused Adam's table over groups with their own
counts, decays and step sizes, and the optimizers' merged launch over 48
LoRA-like groups at two lrs); the grouped EMA update (ema_fused); the splash
forward in sampling's inference form; splash in SDXL's forms (head dim 64);
and the
attention gate: `FORCE_MATH` keeps a
full-width UNet off the splash kernels.

Skips without a CUDA card. Imports no JAX, so it also runs where JAX is not
installed; there, skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from scal_sdt_tpu_torch.ops import adam8_fused as A8
from scal_sdt_tpu_torch.ops import adam_bf16_fused as AF
from scal_sdt_tpu_torch.ops import ema_fused as EF
from scal_sdt_tpu_torch.ops import splash as S
from scal_sdt_tpu_torch.training.quantized import bias_corrections


def _heads(t: torch.Tensor, shape, layout: str) -> torch.Tensor:
    """t as the (B, H, L, D) input: itself, or the head-split strided view of
    a (B, L, H*D) tensor, as ops/attention.py:_split_heads hands it over."""
    if layout == "contiguous":
        return t
    b, h, l, d = shape
    return t.view(b, l, h, d).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "heads"])
@pytest.mark.parametrize("shape", [(2, 8, 1024, 40), (1, 8, 1344, 40), (1, 4, 1100, 80),
                                   (1, 2, 1024, 64), (1, 2, 1030, 160), (1, 3, 1090, 40),
                                   (2, 2, 1031, 80)])
def test_kernels_match_reference_on_cuda(shape, layout):
    """splash_attention (kernels, autograd) against autograd of the plain
    version, at the bounds of the JAX splash tests: forward 5e-3 max-abs,
    gradients 1.5e-2 relative. Lengths that no 64- or 128-row tile divides
    leave a short tail."""
    if not torch.cuda.is_available():
        pytest.skip("the splash kernels run on a CUDA card only")
    r = np.random.RandomState(5)
    b, h, l, d = shape
    base = (b, h, l, d) if layout == "contiguous" else (b, l, h * d)
    q, k, v = (torch.from_numpy(r.randn(*base).astype(np.float32)).cuda().bfloat16()
               for _ in range(3))
    g = torch.from_numpy(r.randn(*shape).astype(np.float32)).cuda().bfloat16()
    scale = d ** -0.5
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    refs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = S.splash_attention(*(_heads(t, shape, layout) for t in leaves), scale)
    want = S.splash_attention_reference(*(_heads(t, shape, layout) for t in refs), scale)
    out.backward(g)
    want.backward(g)
    assert float((out.float() - want.float()).abs().max()) < 5e-3
    for got, ref in zip(leaves, refs):
        err = (got.grad.float() - ref.grad.float()).abs().max() / ref.grad.float().abs().max()
        assert float(err) < 1.5e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("the kernels run on a CUDA card only")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 4096, 40), (2, 8, 1024, 80), (2, 8, 5632, 40),
                                   (2, 8, 1408, 80)])
def test_splash_forward_in_the_sampling_forms_on_cuda(shape):
    """Sampling's form of the forward: under torch.inference_mode, at the CFG
    pair's batch of 2, 512^2 and 704x512 latents (L = 5632 and 1408, which
    no 256-row block divides), head-split views: splash_attention launches
    splash_fwd once and no backward kernel, within 5e-3 max-abs of its plain
    version."""
    _need_card()
    r = np.random.RandomState(7)
    b, h, l, d = shape
    q, k, v = (_heads(torch.from_numpy(r.randn(b, l, h * d).astype(np.float32)).cuda()
                      .bfloat16(), shape, "heads") for _ in range(3))
    S.reset_launches()
    with torch.inference_mode():
        out = S.splash_attention(q, k, v, d ** -0.5)
        want = S.splash_attention_reference(q, k, v, d ** -0.5)
    assert S.launches == {"splash_fwd": 1, "splash_dq": 0, "splash_dkv": 0}
    assert out.is_inference() and out.shape == shape
    assert float((out.float() - want.float()).abs().max()) < 5e-3


SDXL_TRAIN_SHAPES = [(1, 10, 4096, 64), (1, 20, 1024, 64), (1, 10, 4032, 64)]
SDXL_SAMPLE_SHAPES = [(2, 10, 4096, 64), (2, 20, 1024, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SDXL_TRAIN_SHAPES + SDXL_SAMPLE_SHAPES)
def test_splash_in_the_sdxl_forms_on_cuda(shape):
    """SDXL's head dim 64 (the kernels' DP = 64 instances) on head-split
    views: at 1024^2 training's levels 1 and 2 at batch 1 and the ragged ARB
    length 72 x 56 = 4032, forward and backward against autograd of the
    plain version (forward 5e-3 max-abs, gradients 1.5e-2 relative);
    sampling's CFG pair (batch 2) under inference mode, the forward alone."""
    _need_card()
    r = np.random.RandomState(11)
    b, h, l, d = shape
    base = [torch.from_numpy(r.randn(b, l, h * d).astype(np.float32)).cuda().bfloat16()
            for _ in range(3)]
    scale = d ** -0.5
    if shape in SDXL_SAMPLE_SHAPES:
        with torch.inference_mode():
            views = [_heads(t, shape, "heads") for t in base]
            S.reset_launches()
            out = S.splash_attention(*views, scale)
            assert S.launches == {"splash_fwd": 1, "splash_dq": 0, "splash_dkv": 0}
            want = S.splash_attention_reference(*views, scale)
        assert float((out.float() - want.float()).abs().max()) < 5e-3
        return
    g = torch.from_numpy(r.randn(*shape).astype(np.float32)).cuda().bfloat16()
    leaves = [t.clone().requires_grad_(True) for t in base]
    refs = [t.clone().requires_grad_(True) for t in base]
    S.reset_launches()
    out = S.splash_attention(*(_heads(t, shape, "heads") for t in leaves), scale)
    out.backward(g)
    assert S.launches == {"splash_fwd": 1, "splash_dq": 1, "splash_dkv": 1}
    want = S.splash_attention_reference(*(_heads(t, shape, "heads") for t in refs), scale)
    want.backward(g)
    assert float((out.float() - want.float()).abs().max()) < 5e-3
    for got, ref in zip(leaves, refs):
        err = (got.grad.float() - ref.grad.float()).abs().max() / ref.grad.float().abs().max()
        assert float(err) < 1.5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [168, 192, 256, 44])
def test_head_dims_the_kernels_refuse_take_the_math_path_on_cuda(d):
    """A bf16 self-attention at (1, 2, 1024, D) on the card whose head dim
    the kernels refuse (above 160, or not a multiple of 8) runs through
    multi_head_attention on the math path: no kernel launch, and the result
    equals _attention_math on the same head views."""
    from scal_sdt_tpu_torch.ops import attention as A

    _need_card()
    r = np.random.RandomState(d)
    q, k, v = (torch.from_numpy(r.randn(1, 1024, 2 * d).astype(np.float32)).cuda().bfloat16()
               for _ in range(3))
    S.reset_launches()
    out = A.multi_head_attention(q, k, v, 2)
    torch.cuda.synchronize()
    assert sum(S.launches.values()) == 0
    want = A._merge_heads(A._attention_math(*(A._split_heads(t, 2) for t in (q, k, v)),
                                            d ** -0.5))
    assert out.shape == (1, 1024, 2 * d) and torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["narrow", "wide"])
@pytest.mark.parametrize("layout", ["contiguous", "heads"])
@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 96, 120, 160])
def test_splash_fwd_matches_reference_on_cuda(d, layout, grid):
    """splash_fwd against its plain version, one head dim per compiled
    instance (DP 16-160), at ragged lengths Lq != Lk that no 64- or 128-row
    tile divides (the last key tile partly past Lk, the last query rows past
    Lq), in both of its launch shapes: a grid of a few CTAs takes the narrow
    one (one consumer fewer), (8, 16, 1100) queries over 1031 keys the wide
    one, on 132 SMs. O within 5e-3 max-abs, lse within 1e-4; a second call
    gives the same bits (one CTA owns its output rows)."""
    _need_card()
    r = np.random.RandomState(200 + d)
    b, h, lq, lk = (2, 3, 300, 217) if grid == "narrow" else (8, 16, 1100, 1031)

    def make(length):
        shape = (b, h, length, d)
        base = shape if layout == "contiguous" else (b, length, h * d)
        t = torch.from_numpy(r.randn(*base).astype(np.float32)).cuda().bfloat16()
        return _heads(t, shape, layout)

    qs = S._prescale(make(lq), d ** -0.5)
    k, v = make(lk), make(lk)
    want_o, want_lse = S.splash_fwd_reference(qs, k, v)
    o, lse = S.splash_fwd(qs, k, v)
    again = S.splash_fwd(qs, k, v)
    torch.cuda.synchronize()
    assert o.shape == qs.shape and lse.shape == (b, h, lq)
    assert float((o.float() - want_o.float()).abs().max()) < 5e-3
    assert float((lse - want_lse).abs().max()) < 1e-4
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "heads"])
@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 96, 120, 160])
def test_splash_dq_matches_reference_on_cuda(d, layout):
    """splash_dq against its plain version, one head dim per compiled
    instance (DP 16-160), at ragged lengths Lq != Lk that no 64-row tile
    divides: dq within 1.5e-2 relative, delta within 1e-5 of its largest
    entry; a second call gives the same bits (one CTA owns its dq rows, no
    atomics)."""
    _need_card()
    r = np.random.RandomState(d)
    b, h, lq, lk = 2, 3, 300, 217

    def make(length):
        shape = (b, h, length, d)
        base = shape if layout == "contiguous" else (b, length, h * d)
        t = torch.from_numpy(r.randn(*base).astype(np.float32)).cuda().bfloat16()
        return _heads(t, shape, layout)

    qs = S._prescale(make(lq), d ** -0.5)
    k, v, do = make(lk), make(lk), make(lq)
    o, lse = S.splash_fwd(qs, k, v)
    want_dq, want_delta = S.splash_dq_reference(qs, k, v, o, do, lse)
    dq, delta = S.splash_dq(qs, k, v, o, do, lse)
    again = S.splash_dq(qs, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert dq.shape == qs.shape and delta.shape == (b, h, lq)
    err = (dq.float() - want_dq.float()).abs().max() / want_dq.float().abs().max()
    assert float(err) < 1.5e-2
    assert float((delta - want_delta).abs().max()) <= 1e-5 * float(want_delta.abs().max())
    assert torch.equal(dq, again[0]) and torch.equal(delta, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "heads"])
@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 96, 120, 160])
def test_splash_dkv_matches_reference_on_cuda(d, layout):
    """splash_dkv against its plain version on the delta splash_dq wrote,
    one head dim per compiled instance (DP 16-160), at ragged lengths
    Lq != Lk that no 32-, 64- or 128-row tile divides: dk and dv within
    1.5e-2 relative; a second call gives the same bits (one CTA owns its dk
    and dv rows, no atomics)."""
    _need_card()
    r = np.random.RandomState(100 + d)
    b, h, lq, lk = 2, 3, 300, 217

    def make(length):
        shape = (b, h, length, d)
        base = shape if layout == "contiguous" else (b, length, h * d)
        t = torch.from_numpy(r.randn(*base).astype(np.float32)).cuda().bfloat16()
        return _heads(t, shape, layout)

    qs = S._prescale(make(lq), d ** -0.5)
    k, v, do = make(lk), make(lk), make(lq)
    o, lse = S.splash_fwd(qs, k, v)
    _, delta = S.splash_dq(qs, k, v, o, do, lse)
    want_dk, want_dv = S.splash_dkv_reference(qs, k, v, do, lse, delta)
    dk, dv = S.splash_dkv(qs, k, v, do, lse, delta)
    again = S.splash_dkv(qs, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert dk.shape == k.shape and dv.shape == v.shape
    for got, want in ((dk, want_dk), (dv, want_dv)):
        err = (got.float() - want.float()).abs().max() / want.float().abs().max()
        assert float(err) < 1.5e-2
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


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


def _views(sizes, dtype, offsets, r, scale=1e-2):
    """Seeded CUDA tensors of ``sizes`` elements (|values| for a negative
    scale), leaf i a view ``offsets[i]`` elements into a larger buffer (an
    address off 16 bytes when the offset times the element size is not a
    multiple of 16)."""
    out = []
    for n, off in zip(sizes, offsets):
        x = r.randn(n + off).astype(np.float32)
        x = np.abs(x) * -scale if scale < 0 else x * scale
        out.append(torch.from_numpy(x).cuda().to(dtype)[off:])
    return out


def _copies(ts):
    """Copies at the same offsets into new buffers (so as far off 16 bytes)."""
    out = []
    for t in ts:
        off = t.storage_offset()
        buf = torch.empty(off + t.numel(), dtype=t.dtype, device=t.device)
        out.append(buf[off:].view(t.shape).copy_(t))
    return out


# Leaf sizes of a group, and per tensor the offsets of the leaves' views: the
# sixth leaf's tensors are off 16 bytes by different amounts (no element at
# which all are aligned: it runs one element at a time); the seventh's by
# 4 elements each (8 bytes for 2-byte dtypes, 16 for fp32: the vectors start
# at element 4 after a scalar head).
GROUP_SIZES = [1, 7, 320, 2880 * 320, 8192 + 9, 1000, 5000]


def _offsets(last: int) -> list[int]:
    return [0, 0, 0, 0, 0, last, 4]


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["wd0", "wd"])
@pytest.mark.parametrize("form", ["adamw", "int8_path"])
@pytest.mark.parametrize("p_dt", [torch.bfloat16, torch.float32], ids=["bf16_master", "fp32_master"])
@pytest.mark.parametrize("m_dt", [torch.bfloat16, torch.float32], ids=["bf16_moments", "fp32_moments"])
def test_adam_bf16_group_matches_reference_on_cuda(m_dt, p_dt, form, wd):
    """The grouped adam_bf16_fused (Adam, decay, schedule, master apply in
    one launch) against its plain chain leaf by leaf on a ragged leaf set:
    masters and moments bit for bit; a second launch from the same state
    gives the same bits. ``form``: AdamW's (divide, fp32 update, nu by SR
    where it is bf16) or the int8 path's fp32-moment leaves' (reciprocal,
    update in the gradient's dtype)."""
    _adam_bf16_group_case(m_dt, p_dt, form, wd, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("form,m_dt", [("adamw", torch.bfloat16), ("int8_path", torch.float32)],
                         ids=["adamw", "int8_path"])
def test_adam_bf16_group_takes_fp32_gradients_on_cuda(form, m_dt):
    """The same with fp32 gradients, as gradient accumulation hands the
    groups their mean, on bf16 masters: AdamW's group (bf16 moments) and the
    int8 path's fp32-moment leaves (whose update is then fp32 too)."""
    _adam_bf16_group_case(m_dt, torch.bfloat16, form, 1e-2, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["wd0", "wd"])
@pytest.mark.parametrize("g_dt", [torch.bfloat16, torch.float32], ids=["bf16_grads", "fp32_grads"])
def test_adam_bf16_xla_mode_matches_reference_on_cuda(g_dt, wd):
    """The ``xla`` mode (AdamW's default path: fp32 moments and masters,
    XLA's rounding of plain ``scale_by_adam`` and of the decay) against its
    plain version: the single-leaf update's step and moments, and the
    grouped launch's masters and moments, all bit for bit."""
    _need_card()
    r = np.random.RandomState(5)
    shape = (1280, 2304)
    g = torch.from_numpy(r.randn(*shape).astype(np.float32) * 1e-3).cuda().to(g_dt)
    mu = torch.from_numpy(r.randn(*shape).astype(np.float32) * 1e-4).cuda()
    nu = torch.from_numpy(np.abs(r.randn(*shape)).astype(np.float32) * 1e-7).cuda()
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, out_dtype=torch.float32, recip_bc=False, xla=True)
    bc = (np.float32(1) - np.float32(0.9) ** 7, np.float32(1) - np.float32(0.999) ** 7)
    want = AF.adam_bf16_fused_update_reference(g, mu.clone(), nu.clone(), bc, **kw)
    got = AF.adam_bf16_fused_update(g, mu, nu, bc, **kw)
    torch.cuda.synchronize()
    for a, b, what in zip(got, want, ("out", "mu", "nu")):
        assert torch.equal(a, b), what
    _adam_bf16_group_case(torch.float32, torch.float32, "adamw", wd, g_dt, xla=True)


# the ragged leaf set in three groups, each with its own count, decay and step size
GROUP_CUTS = [0, 2, 4, len(GROUP_SIZES)]


def _groups(xs):
    return [xs[a:b] for a, b in zip(GROUP_CUTS, GROUP_CUTS[1:])]


def _adam_bf16_group_case(m_dt, p_dt, form, wd, g_dt, xla=False):
    _need_card()
    r = np.random.RandomState(3)
    keys = [f"unet.l{i}.weight" for i in range(len(GROUP_SIZES))]
    params = _views(GROUP_SIZES, p_dt, _offsets(3), r)
    mu = _views(GROUP_SIZES, m_dt, _offsets(1), r, scale=1e-4)
    nu = _views(GROUP_SIZES, m_dt, _offsets(3), r, scale=-1e-7)
    grads = _views(GROUP_SIZES, g_dt, _offsets(5), r, scale=1e-3)
    steps = [AF.GroupStep(bias_corrections(0.9, 0.999, count), count, decay, size)
             for count, decay, size in ((4, wd, -1e-3 * 0.7), (9, 0.0, -5e-3),
                                        (2, 3 * wd, -2e-4))]
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, recip_bc=form != "adamw", step=9,
              update_dtype=torch.float32 if form == "adamw" else None, xla=xla)
    results = []
    for _ in range(2):
        t = AF.build_adam_table(_groups(keys), _copies(params), _copies(mu), _copies(nu))
        before = AF.launches["adam_bf16_fused"]
        AF.adam_bf16_fused_apply(t, grads, steps, **kw)
        assert AF.launches["adam_bf16_fused"] == before + 1
        results.append(t)
    want = AF.build_adam_table(_groups(keys), _copies(params), _copies(mu), _copies(nu))
    AF.adam_bf16_fused_apply_reference(want, grads, steps, **kw)
    torch.cuda.synchronize()
    got, again = results
    for i, k in enumerate(keys):
        for what in ("params", "mu", "nu"):
            a, b, c = (getattr(t, what)[i] for t in (got, again, want))
            assert torch.equal(a, b), f"{what} {k}: two launches differ"
            assert torch.equal(a, c), f"{what} {k}"
        assert not torch.equal(got.params[i], params[i]) or GROUP_SIZES[i] < 8, k


# (optimizer name, master dtype, moment dtype) of the merged launch's forms
MERGED_FORMS = {"xla": ("adamw", "fp32", None), "bf16_moments": ("adamw", "bf16", "bf16"),
                "adamw8bit": ("bitsandbytes.optim.AdamW8bit", "bf16", None)}


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(MERGED_FORMS))
def test_merged_launch_over_many_groups_matches_reference_on_cuda(form):
    """``MultiTransform.update_and_apply`` over 48 LoRA-like groups (two
    factors each, rank 16) at two lrs and decays under a warm-up into a
    cosine schedule: one adam_bf16_fused launch per step, held against the
    plain version of the same merged launch (``MergedLaunch``: its groups'
    leaves and scalars) over 3 steps, masters and moments bit for bit."""
    from scal_sdt_tpu_torch import conf
    from scal_sdt_tpu_torch.training import optimizers as topt

    _need_card()
    name, master, moment = MERGED_FORMS[form]
    opt = {"name": name, "master_dtype": master,
           "params": {"lr": 1e-3, "weight_decay": 1e-2, "eps": 1e-8},
           "lr_scale": {"enabled": False},
           "lr_scheduler": {"name": "cosine", "params": {"T_max": 2, "eta_min": 1e-6},
                            "warmup": {"enabled": True, "init_lr": 1e-6, "steps": 1}}}
    if moment:
        opt["moment_dtype"] = moment
    cfg = conf.merge(conf.default(), conf.Config({"optimizer": opt}))
    r = np.random.RandomState(8)
    widths = [int(w) for w in r.choice([320, 640, 768, 1280, 2560], 48)]
    shapes = {}
    for i, w in enumerate(widths):
        shapes[f"unet.m{i:02d}.lora_A"] = (16, w)
        shapes[f"unet.m{i:02d}.lora_B"] = (widths[(i + 1) % 48], 16)
    labels = {k: k.split(".")[1] for k in shapes}
    overrides = {f"m{i:02d}": ({"lr": 5e-4, "weight_decay": 1e-2} if i % 3
                               else {"lr": 5e-3, "weight_decay": 0.0}) for i in range(48)}
    tx, _ = topt.build_optimizer(cfg, labels, overrides, 4, 1)
    dtype = torch.bfloat16 if master == "bf16" else torch.float32
    masters = {k: torch.from_numpy(r.randn(*s).astype(np.float32) * 0.1).cuda().to(dtype)
               for k, s in shapes.items()}
    plain = {k: v.clone() for k, v in masters.items()}
    state, p_state = tx.init(masters), tx.init(plain)
    for step in range(3):
        grads = {k: torch.from_numpy(r.randn(*s).astype(np.float32) * 1e-3).cuda().bfloat16()
                 for k, s in shapes.items()}
        (merged,) = tx.merged_launches(p_state, plain)
        assert len(merged.labels) == 48
        steps = [tx.transforms[label].group_step(p_state[label].count)
                 for label in merged.labels]
        table = AF.build_adam_table(merged.keys, *merged.tensors(tx.transforms, p_state, plain))
        b1, b2, eps, recip_bc, update_dtype, xla = merged.launch
        AF.adam_bf16_fused_apply_reference(
            table, [grads[k] for ks in merged.keys for k in ks], steps, b1=b1, b2=b2, eps=eps,
            recip_bc=recip_bc, step=step, update_dtype=update_dtype, xla=xla)
        for label in merged.labels:
            p_state[label].count += 1
        before = AF.launches["adam_bf16_fused"]
        state = tx.update_and_apply(grads, state, masters, step)
        assert AF.launches["adam_bf16_fused"] == before + 1
        torch.cuda.synchronize()
        for k in shapes:
            assert torch.equal(masters[k], plain[k]), f"master step {step} {k}"
        for label in tx.transforms:
            for field in ("mu", "nu", "mu_q", "nu_q"):
                for k, v in getattr(state[label], field, {}).items():
                    assert torch.equal(v, getattr(p_state[label], field)[k]), (step, field, k)
    assert len({st.step_size for st in steps}) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("p_dt", [torch.bfloat16, torch.float32], ids=["bf16_master", "fp32_master"])
@pytest.mark.parametrize("s_dt", [torch.bfloat16, torch.float32], ids=["bf16_shadow", "fp32_shadow"])
def test_ema_group_matches_reference_on_cuda(s_dt, p_dt):
    """The grouped EMA update (one launch over a ragged leaf set, views off
    16 bytes) against its plain version leaf by leaf: shadows bit for bit,
    a bf16 shadow under either dither rule (low half of the master store's
    hash for bf16 masters, high half of its own otherwise); a second launch
    from the same state gives the same bits."""
    _need_card()
    r = np.random.RandomState(4)
    keys = [f"unet.l{i}.weight" for i in range(len(GROUP_SIZES))]
    shadows = _views(GROUP_SIZES, s_dt, _offsets(3), r)
    masters = _views(GROUP_SIZES, p_dt, _offsets(5), r)
    one_minus = float(np.float32(1) - np.float32(0.995))
    results = []
    for _ in range(2):
        t = EF.build_ema_table(keys, _copies(shadows), masters)
        before = EF.launches["ema_fused"]
        EF.ema_fused_apply(t, one_minus, 11)
        assert EF.launches["ema_fused"] == before + 1
        results.append(t)
    want = EF.build_ema_table(keys, _copies(shadows), masters)
    EF.ema_fused_apply_reference(want, one_minus, 11)
    torch.cuda.synchronize()
    got, again = results
    for i, k in enumerate(keys):
        assert torch.equal(got.shadows[i], again.shadows[i]), f"{k}: two launches differ"
        assert torch.equal(got.shadows[i], want.shadows[i]), k
        assert not torch.equal(got.shadows[i], shadows[i]) or GROUP_SIZES[i] < 8, k


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["wd0", "wd"])
@pytest.mark.parametrize("p_dt", [torch.bfloat16, torch.float32], ids=["bf16_master", "fp32_master"])
def test_adam8_group_matches_reference_on_cuda(p_dt, wd):
    """The grouped adam8_fused (int8 Adam, decay, schedule, master apply in
    one launch) against its plain chain leaf by leaf, on ragged minors (300,
    2880), rows off 16 bytes (minor 301) and a master off 16 bytes: payloads
    at most 1 apart in under 1e-3 of them, scales within 1e-6 relative,
    masters at most one ulp apart in under 1e-3 of them, padded payload
    columns zero; a second launch from the same state gives the same bits."""
    _adam8_group_case(p_dt, wd, torch.bfloat16)


@pytest.mark.cuda
def test_adam8_group_takes_fp32_gradients_on_cuda():
    """The same with fp32 gradients (gradient accumulation's mean) on bf16
    masters: the update is fp32 too."""
    _adam8_group_case(torch.bfloat16, 1e-2, torch.float32)


def _adam8_group_case(p_dt, wd, g_dt):
    _need_card()
    r = np.random.RandomState(11)
    shapes = [(64, 300), (320, 2880), (3, 256), (33, 301), (40, 432)]
    keys = [f"unet.q{i}.weight" for i in range(len(shapes))]
    offsets = [0, 0, 0, 0, 7]
    params = [t.view(s) for t, s in zip(
        _views([a * b for a, b in shapes], p_dt, offsets, r), shapes)]
    grads = [torch.from_numpy(r.randn(*s).astype(np.float32) * 1e-3).cuda().to(g_dt)
             for s in shapes]
    state = []
    for lead, minor in shapes:
        nb = -(-minor // A8.BLOCK)
        leaf = []
        for sc in (1e-3, 1e-7):
            m = torch.from_numpy(np.abs(r.randn(lead, nb * A8.BLOCK)).astype(np.float32) * sc)
            m.view(lead, nb * A8.BLOCK)[:, minor:] = 0
            q, s = A8.quantize_blocks(m.cuda().view(lead, nb, A8.BLOCK))
            leaf += [q.view(lead, -1).contiguous(), s.view(lead, nb).contiguous()]
        state.append(tuple(leaf))
    inv = (float(1 / (1 - np.float32(0.9) ** 3)), float(1 / (1 - np.float32(0.999) ** 3)))
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, step=5, weight_decay=wd, step_size=-1e-3)

    def table():
        return A8.build_adam8_table(keys, _copies(params), [_copies(s) for s in state])

    got, again, want = table(), table(), table()
    for t in (got, again):
        before = A8.launches["adam8_fused"]
        A8.adam8_fused_apply(t, grads, *inv, **kw)
        assert A8.launches["adam8_fused"] == before + 1
    A8.adam8_fused_apply_reference(want, grads, *inv, **kw)
    torch.cuda.synchronize()
    for i, (k, (lead, minor)) in enumerate(zip(keys, shapes)):
        assert torch.equal(got.params[i], again.params[i]), f"master {k}: launches differ"
        assert all(torch.equal(a, b) for a, b in zip(got.state[i], again.state[i])), k
        for j, name in ((0, "mu_q"), (2, "nu_q")):
            d = (got.state[i][j].int() - want.state[i][j].int()).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3, f"{name} {k}"
            assert not got.state[i][j][:, minor:].any(), f"{name} {k} padded tail"
        for j in (1, 3):
            a, b = got.state[i][j], want.state[i][j]
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), f"scale {k}"
        a, b = got.params[i].float(), want.params[i].float()
        ulp = torch.finfo(p_dt).eps * torch.maximum(a.abs(), b.abs())
        off = (a - b).abs() > 0
        assert bool(((a - b).abs() <= ulp).all()), f"master {k}"
        assert float(off.float().mean()) < 1e-3, f"master {k}"
        assert not torch.equal(got.params[i], params[i]), k


@pytest.mark.cuda
def test_force_math_keeps_the_unet_off_the_splash_kernels_on_cuda():
    """With ``FORCE_MATH`` set (the config's ``xformers: false``) a
    full-width SD1.5 UNet forward and backward at 512^2 (64^2 latents, bf16)
    launches no splash kernel; with it clear, the same call launches each
    splash kernel once per self-attention at L >= 1024 (5 at 4096, 5 at
    1024)."""
    from scal_sdt_tpu_torch.models.unet import UNetConfig, init_unet_params, unet_apply
    from scal_sdt_tpu_torch.ops import attention as A

    _need_card()
    cfg = UNetConfig.sd15()
    params = {k: v.bfloat16().requires_grad_(True)
              for k, v in init_unet_params(cfg, seed=0, device="cuda").items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, 4, 64, 64, generator=gen, device="cuda").bfloat16()
    ctx = torch.randn(1, 77, cfg.cross_attention_dim, generator=gen, device="cuda").bfloat16()
    t = torch.tensor([500], device="cuda")
    counts = {}
    try:
        for force in (True, False):
            A.FORCE_MATH = force
            S.reset_launches()
            out = unet_apply(params, x, t, ctx, cfg)
            out.float().square().mean().backward()
            torch.cuda.synchronize()
            counts[force] = dict(S.launches)
    finally:
        A.FORCE_MATH = False
    assert sum(counts[True].values()) == 0, counts
    assert all(n == 10 for n in counts[False].values()), counts
