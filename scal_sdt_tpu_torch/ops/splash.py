"""Splash attention on Hopper: the port of ``scal_sdt_tpu/ops/splash.py``.

The TPU version wraps JAX's Pallas splash kernels (forward, and separate dq
and dkv backward passes). Here the same three passes are CUDA kernels written
for ``sm_90a`` (``ops/csrc``), launched through ``ctypes`` and tied together
by a ``torch.autograd.Function``:

* ``splash_fwd``  -> (O, logsumexp)          csrc/splash_fwd.cu
* ``splash_dq``   -> (dq, delta=rowsum(dO*O)) csrc/splash_bwd.cu
* ``splash_dkv``  -> (dk, dv)                 csrc/splash_bwd.cu

Inputs are (B, H, L, D) bf16 views with a unit stride over D (the head-split
views of ``ops/attention.py`` go in without a copy); D is a multiple of 8 and
at most 160. The kernels bound ragged L tails themselves, so any length runs,
including the ARB bucket lengths the TPU version pads to a block multiple.

Each wrapper counts its launches in ``launches``. ``splash_attention`` takes
the kernels for CUDA tensors and the plain version
(``splash_attention_reference``) for CPU tensors; it never falls back from
one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_HEAD_DIM = 160

# Launch counts per kernel wrapper; a caller resets them to 0 before the run
# it wants to count.
launches = {"splash_fwd": 0, "splash_dq": 0, "splash_dkv": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def pick_block(length: int, preferred: int = 512) -> int | None:
    """Largest power-of-two block <= preferred that divides `length` (None
    when only blocks below 128 divide it: the TPU version's padded case)."""
    b = 128
    while b * 2 <= preferred:
        b *= 2
    while b >= 128:
        if length % b == 0:
            return b
        b //= 2
    return None


def _prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale in q's dtype, the scale itself rounded to that dtype first,
    exactly as the JAX wrapper does before its kernel."""
    return q * q.new_full((), scale)


def _scores(qs: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.matmul(qs.float(), k.float().transpose(-1, -2))


def splash_fwd_reference(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``splash_fwd``: fp32 scores and softmax,
    probabilities rounded to the input dtype before the product with v."""
    scores = _scores(qs, k)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None]).to(qs.dtype)
    return torch.matmul(probs, v), lse


def splash_dq_reference(qs, k, v, o, do, lse) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``splash_dq``."""
    delta = (do.float() * o.float()).sum(-1)
    p = torch.exp(_scores(qs, k) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(qs.dtype)
    return torch.matmul(ds, k), delta


def splash_dkv_reference(qs, k, v, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``splash_dkv``."""
    p = torch.exp(_scores(qs, k) - lse[..., None])
    dv = torch.matmul(p.to(qs.dtype).transpose(-1, -2), do)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(qs.dtype)
    return torch.matmul(ds.transpose(-1, -2), qs), dv


def splash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """Plain PyTorch version of ``splash_attention`` (differentiable through
    autograd): the same pre-scale rounding, fp32 softmax."""
    return splash_fwd_reference(_prescale(q, scale), k, v)[0]


def _check(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 4:
        raise TypeError(f"splash kernel: {name} must be a 4-d bf16 CUDA tensor, "
                        f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"splash kernel: {name} needs a unit stride over D and "
                         f"16-byte aligned rows, got strides {t.stride()}")


def _check_inputs(q, k, v) -> tuple[int, int, int, int, int]:
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t)
        if t.device != q.device:
            raise ValueError(f"splash kernel: {name} on {t.device}, q on {q.device}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"splash kernel: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if d % 8 or d > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"splash kernel: head dim {d} (needs a multiple of 8, at most {MAX_HEAD_DIM})")
    if b * h > 65535:
        raise NotImplementedError(f"splash kernel: B*H = {b * h} exceeds the grid")
    return b, h, lq, lk, d


def _check_rows(name: str, t: torch.Tensor, ref: torch.Tensor, shape) -> None:
    """lse / delta: contiguous fp32 (B, H, Lq) on q's device."""
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.device != ref.device):
        raise ValueError(f"splash kernel: {name} must be contiguous fp32 {tuple(shape)} on "
                         f"{ref.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _like_heads(b: int, h: int, length: int, d: int, ref: torch.Tensor) -> torch.Tensor:
    """(B, H, L, D) output whose memory is (B, L, H, D): merging heads after
    it is a free view."""
    return torch.empty(b, length, h, d, dtype=ref.dtype, device=ref.device).transpose(1, 2)


def _strides(*ts: torch.Tensor):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def splash_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel on pre-scaled q: (O bf16 (B,H,Lq,D), lse fp32 (B,H,Lq))."""
    b, h, lq, lk, d = _check_inputs(qs, k, v)
    lib = _build.load_library()
    o = _like_heads(b, h, lq, d, qs)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=qs.device)
    with torch.cuda.device(qs.device):
        err = lib.ssdt_splash_fwd(qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  lse.data_ptr(), b, h, lq, lk, d, _strides(qs, k, v, o),
                                  _stream())
    _build.check(lib, "splash_fwd", err)
    launches["splash_fwd"] += 1
    return o, lse


def splash_dq(qs, k, v, o, do, lse) -> tuple[torch.Tensor, torch.Tensor]:
    """dq kernel: (dq w.r.t. the pre-scaled q, delta fp32 (B,H,Lq))."""
    b, h, lq, lk, d = _check_inputs(qs, k, v)
    for name, t in (("o", o), ("do", do)):
        _check(name, t)
        if t.shape != qs.shape:
            raise ValueError(f"splash kernel: {name} {tuple(t.shape)} != q {tuple(qs.shape)}")
    _check_rows("lse", lse, qs, (b, h, lq))
    lib = _build.load_library()
    dq = _like_heads(b, h, lq, d, qs)
    delta = torch.empty(b, h, lq, dtype=torch.float32, device=qs.device)
    with torch.cuda.device(qs.device):
        err = lib.ssdt_splash_dq(qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                 b, h, lq, lk, d, _strides(qs, k, v, o, do, dq), _stream())
    _build.check(lib, "splash_dq", err)
    launches["splash_dq"] += 1
    return dq, delta


def splash_dkv(qs, k, v, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """dkv kernel: (dk, dv); reads the delta that ``splash_dq`` wrote."""
    b, h, lq, lk, d = _check_inputs(qs, k, v)
    _check("do", do)
    if do.shape != qs.shape:
        raise ValueError(f"splash kernel: do {tuple(do.shape)} != q {tuple(qs.shape)}")
    _check_rows("lse", lse, qs, (b, h, lq))
    _check_rows("delta", delta, qs, (b, h, lq))
    lib = _build.load_library()
    dk = _like_heads(b, h, lk, d, k)
    dv = _like_heads(b, h, lk, d, v)
    with torch.cuda.device(qs.device):
        err = lib.ssdt_splash_dkv(qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                  b, h, lq, lk, d, _strides(qs, k, v, do, dk, dv), _stream())
    _build.check(lib, "splash_dkv", err)
    launches["splash_dkv"] += 1
    return dk, dv


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """An incoming gradient with a layout the kernels cannot address is
    copied once (the UNet's gradients arrive addressable and are not)."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        return t.contiguous()
    return t


class _SplashFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qs, k, v):
        o, lse = splash_fwd(qs, k, v)
        ctx.save_for_backward(qs, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        do = _kernel_ready(do)
        dq, delta = splash_dq(qs, k, v, o, do, lse)
        dk, dv = splash_dkv(qs, k, v, do, lse, delta)
        return dq, dk, dv


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """q, k, v: (B, H, L, D) -> (B, H, Lq, D). Non-causal.

    CUDA tensors run the kernels (and raise on what they do not take); CPU
    tensors run ``splash_attention_reference``."""
    if not q.is_cuda:
        return splash_attention_reference(q, k, v, scale)
    return _SplashFunction.apply(_prescale(q, scale), k, v)
