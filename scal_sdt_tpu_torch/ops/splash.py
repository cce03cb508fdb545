"""Splash attention on Hopper: the port of ``scal_sdt_tpu/ops/splash.py``.

The TPU version wraps JAX's Pallas splash kernels (forward, and separate dq
and dkv backward passes). Here the same three passes are CUDA kernels written
for ``sm_90a`` (``ops/csrc``), launched through ``ctypes`` and tied together
by a ``torch.autograd.Function``:

* ``splash_fwd``  -> (O, logsumexp)          csrc/splash_fwd.cu
* ``splash_dq``   -> (dq, delta=rowsum(dO*O)) csrc/splash_bwd.cu
* ``splash_dkv``  -> (dk, dv)                 csrc/splash_bwd.cu

All three run on Hopper's warpgroup ``wgmma`` with their tiles loaded by TMA
(one tensor map per operand, whose geometry ``tma_geometry`` computes here;
the forward also writes O by a TMA store). A producer warp keeps the loads in
flight while consumer warpgroups take turns at issuing products, so one
group's exponentials, the forward's floor at small head dims, run under
another's products.

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
import struct

import torch

from . import _build

MAX_HEAD_DIM = 160
MAX_GRID_Y = 65535   # B*H runs on the grid's y dimension


def kernel_accepts(shape, dtype: torch.dtype) -> bool:
    """Whether the kernels take (B, H, L, D) inputs of ``dtype``: bf16, D a
    multiple of 8 and at most ``MAX_HEAD_DIM``, B*H within the grid. The
    attention gate asks this before it sends a call here."""
    b, h, _, d = shape
    return (dtype == torch.bfloat16 and d % 8 == 0 and d <= MAX_HEAD_DIM
            and b * h <= MAX_GRID_Y)


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


def _check(name: str, t: torch.Tensor) -> tuple[int, ...]:
    """dq's o (read by 16-byte loads): its strides."""
    if not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 4:
        raise TypeError(f"splash kernel: {name} must be a 4-d bf16 CUDA tensor, "
                        f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    st = t.stride()
    if st[3] != 1 or st[0] % 8 or st[1] % 8 or st[2] % 8 or t.data_ptr() % 16:
        raise ValueError(f"splash kernel: {name} needs a unit stride over D and "
                         f"16-byte aligned rows, got strides {st}")
    return st


def _check_cuda(*named: tuple[str, torch.Tensor]) -> None:
    """Operands (name, tensor): 4-d bf16 CUDA tensors on the first one's device."""
    device = named[0][1].device
    for name, t in named:
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 4:
            raise TypeError(f"splash kernel: {name} must be a 4-d bf16 CUDA tensor, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.device != device:
            raise ValueError(f"splash kernel: {name} on {t.device}, {named[0][0]} on {device}")


def _check_shapes(q, k, v) -> tuple[int, int, int, int, int]:
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"splash kernel: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if not kernel_accepts(q.shape, q.dtype):
        raise NotImplementedError(
            f"splash kernel: head dim {d} (needs a multiple of 8, at most {MAX_HEAD_DIM}) "
            f"or B*H = {b * h} (at most {MAX_GRID_Y})")
    return b, h, lq, lk, d


def _check_rows(name: str, t: torch.Tensor, ref: torch.Tensor, shape) -> None:
    """lse / delta: contiguous fp32 (B, H, Lq) on q's device."""
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.device != ref.device):
        raise ValueError(f"splash kernel: {name} must be contiguous fp32 {tuple(shape)} on "
                         f"{ref.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


TMA_MAX_STRIDE = 1 << 40   # a tensor map's byte strides: multiples of 16 below this


def tma_geometry(t: torch.Tensor) -> list[int]:
    """The kernels' TMA tensor map of a (B, H, L, D) bf16 view: dims
    (8, L, D/8, H, B) and the byte strides of dims 1-4 (row, the 16-byte
    chunk of 8 columns, head, batch). One box of that map is a chunk-major
    tile (``csrc/splash_hopper.cuh``). Raises ValueError for a view TMA
    cannot address: no unit stride over D, D not a multiple of 8, a base
    not 16-byte aligned, or a stride of a dim longer than 1 that is not a
    positive multiple of 16 bytes below 2**40 (a dim of length 1 takes any
    stride: its coordinate is always 0)."""
    b, h, l, d = t.shape
    sb, sh, sl, sd = t.stride()
    es = t.element_size()
    if sd != 1 or d % 8 or t.data_ptr() % 16:
        raise ValueError(f"splash kernel: TMA needs a unit stride over D (a multiple of 8) and "
                         f"a 16-byte aligned base, got strides {t.stride()}, D = {d}")
    row, head = sl * es if l > 1 else 16, sh * es if h > 1 else 16
    batch = sb * es if b > 1 else 16
    if ((row | head | batch) % 16 or min(row, head, batch) <= 0
            or max(row, head, batch) >= TMA_MAX_STRIDE):
        for name, nbytes in (("row", row), ("head", head), ("batch", batch)):
            if nbytes <= 0 or nbytes % 16 or nbytes >= TMA_MAX_STRIDE:
                raise ValueError(f"splash kernel: TMA cannot address a {name} stride of "
                                 f"{nbytes // es} elements (needs a positive multiple of 16 "
                                 f"bytes below 2**40)")
    return [8, l, d // 8, h, b, row, 16, head, batch]


def _like_heads(b: int, h: int, length: int, d: int, ref: torch.Tensor) -> torch.Tensor:
    """(B, H, L, D) output whose memory is (B, L, H, D): merging heads after
    it is a free view."""
    return torch.empty_strided((b, h, length, d), (length * h * d, d, h * d, 1),
                               dtype=ref.dtype, device=ref.device)


_MAPS = ctypes.c_longlong * 36
_PACK_MAPS = struct.Struct("36q")


def tile_maps(*ts: torch.Tensor) -> ctypes.Array:
    """A kernel's argument of tile maps: ``tma_geometry`` of each of its four
    (B, H, L, D) operands (forward: q, k, v, o; backward: q, k, v, dO), 9
    values each, one stride read per operand (a launch's host time bounds
    the small forms). Raises ValueError for a view TMA cannot address."""
    geo = []
    for t in ts:
        geo += tma_geometry(t)
    return _MAPS.from_buffer_copy(_PACK_MAPS.pack(*geo))


def _check_bwd(qs, k, v, do):
    """The backward's four TMA operands q, k, v, dO: bf16 CUDA tensors on one
    device that TMA can address, of matching shapes. Returns (b, h, lq, lk,
    d) and their tile maps."""
    _check_cuda(("q", qs), ("k", k), ("v", v), ("do", do))
    if do.shape != qs.shape:
        raise ValueError(f"splash kernel: do {tuple(do.shape)} != q {tuple(qs.shape)}")
    return _check_shapes(qs, k, v), tile_maps(qs, k, v, do)


_LL6 = ctypes.c_longlong * 6   # (batch, head, row) strides of two views


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device: int) -> int:
    """The current CUDA stream's handle on ``device``."""
    if _raw_stream is not None:
        return _raw_stream(device)
    return torch.cuda.current_stream(device).cuda_stream


def _call(fn, device: int, *args) -> int:
    """fn(*args, stream) with ``device`` current (entered only when it is not)."""
    if device == torch.cuda.current_device():
        return fn(*args, _stream(device))
    with torch.cuda.device(device):
        return fn(*args, _stream(device))


def splash_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel on pre-scaled q: (O bf16 (B,H,Lq,D), lse fp32 (B,H,Lq)).
    q, k and v must be views TMA can address (``tma_geometry``; the autograd
    Function copies one that is not)."""
    _check_cuda(("q", qs), ("k", k), ("v", v))
    b, h, lq, lk, d = _check_shapes(qs, k, v)
    o = _like_heads(b, h, lq, d, qs)
    maps = tile_maps(qs, k, v, o)
    lib = _build.load_library()
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=qs.device)
    err = _call(lib.ssdt_splash_fwd, qs.get_device(), qs.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, lq, lk, d, maps)
    _build.check(lib, "splash_fwd", err)
    launches["splash_fwd"] += 1
    return o, lse


def splash_dq(qs, k, v, o, do, lse) -> tuple[torch.Tensor, torch.Tensor]:
    """dq kernel: (dq w.r.t. the pre-scaled q, delta fp32 (B,H,Lq))."""
    (b, h, lq, lk, d), geo = _check_bwd(qs, k, v, do)
    so = _check("o", o)
    if o.shape != qs.shape or o.device != qs.device:
        raise ValueError(f"splash kernel: o {tuple(o.shape)} on {o.device} != q "
                         f"{tuple(qs.shape)} on {qs.device}")
    _check_rows("lse", lse, qs, (b, h, lq))
    lib = _build.load_library()
    dq = _like_heads(b, h, lq, d, qs)
    delta = torch.empty(b, h, lq, dtype=torch.float32, device=qs.device)
    strides = _LL6(*so[:3], lq * h * d, d, h * d)   # o, and dq as _like_heads lays it out
    err = _call(lib.ssdt_splash_dq, qs.get_device(), qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                b, h, lq, lk, d, strides, geo)
    _build.check(lib, "splash_dq", err)
    launches["splash_dq"] += 1
    return dq, delta


def splash_dkv(qs, k, v, do, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """dkv kernel: (dk, dv); reads the delta that ``splash_dq`` wrote."""
    (b, h, lq, lk, d), geo = _check_bwd(qs, k, v, do)
    _check_rows("lse", lse, qs, (b, h, lq))
    _check_rows("delta", delta, qs, (b, h, lq))
    lib = _build.load_library()
    dk = _like_heads(b, h, lk, d, k)
    dv = _like_heads(b, h, lk, d, v)
    err = _call(lib.ssdt_splash_dkv, qs.get_device(), qs.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, h, lq, lk, d, _LL6(*(lk * h * d, d, h * d) * 2), geo)
    _build.check(lib, "splash_dkv", err)
    launches["splash_dkv"] += 1
    return dk, dv


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """An operand TMA cannot address (``tma_geometry``) is copied once into
    fresh, aligned memory; the UNet's and the MMDiT's tensors arrive
    addressable and are not."""
    try:
        tma_geometry(t)
    except ValueError:
        return t.clone(memory_format=torch.contiguous_format)
    return t


class _SplashFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qs, k, v):
        qs, k, v = (_kernel_ready(t) for t in (qs, k, v))
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
