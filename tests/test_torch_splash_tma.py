"""The tensor-map geometry of the splash kernels, on the CPU.

``ops/splash.py`` ``tma_geometry`` describes each (B, H, L, D) bf16 operand
of ``splash_fwd`` (q, k, v and its output o), ``splash_dq`` and
``splash_dkv`` (q, k, v, dO) as a 5-d TMA tensor map (8 columns, rows,
16-byte chunks, heads, batch), and ``tile_maps`` lays four of them out as a
kernel's argument; the kernels' C side only adds the box. Here: the
geometry of the layouts the port hands the kernels (contiguous, the
head-split views of ``ops/attention.py``, a tensor-parallel rank's heads,
the kernels' own outputs), every element's address through the map against
torch's own, the views TMA cannot address, and the copy the autograd
Function makes of those before the forward. Also
``chip_smoke.ptxas_lines``, which names each kernel instance in nvcc's
report, and ``csrc/wgmma.cuh`` against its generator.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from scal_sdt_tpu_torch.ops import splash as S
from scripts import gen_wgmma


def _map_offsets(t: torch.Tensor, geo: list[int]) -> np.ndarray:
    """Byte offset from the base of every element of t, through the map:
    element (b, h, l, 8c + e) at l * row + c * 16 + h * head + b * batch + 2e."""
    b, h, l, d = t.shape
    row, chunk, head, batch = geo[5:]
    ib, ih, il, ic = np.meshgrid(np.arange(b), np.arange(h), np.arange(l), np.arange(d),
                                 indexing="ij")
    return il * row + (ic // 8) * chunk + ih * head + ib * batch + (ic % 8) * 2


def _torch_offsets(t: torch.Tensor) -> np.ndarray:
    b, h, l, d = t.shape
    ib, ih, il, ic = np.meshgrid(np.arange(b), np.arange(h), np.arange(l), np.arange(d),
                                 indexing="ij")
    sb, sh, sl, sd = t.stride()
    return (ib * sb + ih * sh + il * sl + ic * sd) * t.element_size()


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, l, hd = x.shape
    return x.view(b, l, h, hd // h).transpose(1, 2)


def _case(name: str) -> torch.Tensor:
    """The layouts the kernels meet, small enough to enumerate."""
    bf = torch.bfloat16
    if name == "contiguous":
        return torch.zeros(2, 3, 37, 40, dtype=bf)
    if name == "head_split":            # ops/attention.py: (B, L, H*D) -> (B, H, L, D)
        return _heads(torch.zeros(2, 37, 3 * 40, dtype=bf), 3)
    if name == "like_heads":            # the kernels' own outputs: (B, L, H, D) memory
        return S._like_heads(2, 3, 37, 64, torch.zeros(1, dtype=bf))
    if name == "tensor_parallel_rank":  # a rank's column half: 4 of 8 heads at D = 40
        return _heads(torch.zeros(8, 33, 4 * 40, dtype=bf), 4)
    if name == "tensor_parallel_slice":  # heads 4-7 of the whole (8, L, 8*40) projection
        return _heads(torch.zeros(8, 33, 8 * 40, dtype=bf), 8)[:, 4:]
    if name == "one_head_batch":        # B = H = 1: those strides take any value
        return torch.zeros(17, 1, 1, 160, dtype=bf).permute(1, 2, 0, 3)
    raise KeyError(name)


CASES = ["contiguous", "head_split", "like_heads", "tensor_parallel_rank",
         "tensor_parallel_slice", "one_head_batch"]


@pytest.mark.parametrize("name", CASES)
def test_every_element_sits_where_the_map_puts_it(name):
    """dims (8, L, D/8, H, B), strides (row, 16, head, batch) in bytes: every
    element's address through the map is torch's own."""
    t = _case(name)
    geo = S.tma_geometry(t)
    b, h, l, d = t.shape
    assert geo[:5] == [8, l, d // 8, h, b]
    assert geo[6] == 16
    assert all(s % 16 == 0 and 0 < s < S.TMA_MAX_STRIDE for s in geo[5:])
    np.testing.assert_array_equal(_map_offsets(t, geo), _torch_offsets(t))


def test_the_tensor_parallel_forms_at_sd15_width():
    """(8, 4, 4096, 40), the smoke's tensor-parallel form: a rank's own half
    and the second half of the whole projection give the same row stride
    pattern a head-split view has, in bytes."""
    bf = torch.bfloat16
    rank = _heads(torch.zeros(8, 4096, 160, dtype=bf), 4)
    whole = _heads(torch.zeros(8, 4096, 320, dtype=bf), 8)[:, 4:]
    assert S.tma_geometry(rank) == [8, 4096, 5, 4, 8, 320, 16, 80, 4096 * 320]
    assert S.tma_geometry(whole) == [8, 4096, 5, 4, 8, 640, 16, 80, 4096 * 640]
    assert whole.data_ptr() % 16 == 0


def _refused(name: str) -> torch.Tensor:
    bf = torch.bfloat16
    if name == "row_stride_not_16_bytes":  # D = 40 narrowed from rows of 44
        return torch.zeros(2, 3, 37, 44, dtype=bf)[..., :40]
    if name == "base_not_16_byte_aligned":
        return torch.zeros(2 * 3 * 37 * 40 + 4, dtype=bf)[4:].view(2, 3, 37, 40)
    if name == "heads_broadcast":          # stride 0 over 3 heads
        return torch.zeros(2, 1, 37, 40, dtype=bf).expand(2, 3, 37, 40)
    if name == "head_dim_not_multiple_of_8":
        return torch.zeros(2, 3, 37, 44, dtype=bf)
    if name == "head_dim_strided":
        return torch.zeros(2, 3, 37, 80, dtype=bf)[..., ::2]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["row_stride_not_16_bytes", "base_not_16_byte_aligned",
                                  "heads_broadcast", "head_dim_not_multiple_of_8",
                                  "head_dim_strided"])
def test_a_view_tma_cannot_address_is_refused(name):
    with pytest.raises(ValueError, match="TMA"):
        S.tma_geometry(_refused(name))


@pytest.mark.parametrize("name", CASES)
def test_the_forwards_maps_are_q_k_v_and_its_output(name):
    """splash_fwd's argument of tile maps: 36 values, the maps of q, k, v and
    the (B, L, H, D)-laid output o in that order, each addressing every
    element where torch does; at Lk != Lq."""
    q = _case(name)
    b, h, l, d = q.shape
    k = _case(name)[:, :, :l - 4]
    v = _case(name)[:, :, 4:]
    o = S._like_heads(b, h, l, d, q)
    maps = list(S.tile_maps(q, k, v, o))
    assert len(maps) == 36
    for i, t in enumerate((q, k, v, o)):
        geo = maps[9 * i:9 * i + 9]
        assert geo == S.tma_geometry(t)
        assert geo[:5] == [8, t.shape[2], d // 8, h, b]
        np.testing.assert_array_equal(_map_offsets(t, geo), _torch_offsets(t))


@pytest.mark.parametrize("slot", [0, 1, 2])
@pytest.mark.parametrize("name", ["row_stride_not_16_bytes", "base_not_16_byte_aligned",
                                  "heads_broadcast", "head_dim_strided"])
def test_the_forwards_maps_refuse_what_tma_cannot_address(name, slot):
    """A q, k or v view TMA cannot address: no tile maps (splash_fwd raises
    the same ValueError before any launch)."""
    ops = [_case("contiguous") for _ in range(3)]
    ops[slot] = _refused(name)
    o = S._like_heads(*ops[0].shape, ops[0])
    with pytest.raises(ValueError, match="TMA"):
        S.tile_maps(*ops, o)


@pytest.mark.parametrize("slot", [0, 1, 2])
@pytest.mark.parametrize("name", ["row_stride_not_16_bytes", "base_not_16_byte_aligned",
                                  "heads_broadcast"])
def test_the_autograd_forward_copies_what_tma_cannot_address(name, slot, monkeypatch):
    """The autograd Function hands splash_fwd a contiguous copy of an operand
    TMA cannot address (equal values) and every addressable one as it is,
    and the backward kernels get the very tensors the forward got."""
    seen = {}

    def fwd(qs, k, v):
        seen["fwd"] = (qs, k, v)
        b, h, lq, d = qs.shape
        return S._like_heads(b, h, lq, d, qs).zero_(), torch.zeros(b, h, lq)

    def dq(qs, k, v, o, do, lse):
        seen["dq"] = (qs, k, v)
        return torch.zeros_like(qs), torch.zeros(lse.shape)

    def dkv(qs, k, v, do, lse, delta):
        seen["dkv"] = (qs, k, v)
        return torch.zeros_like(k), torch.zeros_like(v)

    monkeypatch.setattr(S, "splash_fwd", fwd)
    monkeypatch.setattr(S, "splash_dq", dq)
    monkeypatch.setattr(S, "splash_dkv", dkv)
    given = [_case("head_split") for _ in range(3)]
    given[slot] = _refused(name)
    given = [t.detach().requires_grad_(True) for t in given]
    out = S._SplashFunction.apply(*given)
    out.backward(torch.ones(out.shape, dtype=out.dtype))
    for i, (got, t) in enumerate(zip(seen["fwd"], given)):
        if i == slot:
            assert got.is_contiguous() and torch.equal(got, t.detach())
            S.tma_geometry(got)
        else:
            assert got is t
    for kernel in ("dq", "dkv"):
        for got, want in zip(seen[kernel], seen["fwd"]):
            assert got.data_ptr() == want.data_ptr() and got.stride() == want.stride()


@pytest.mark.parametrize("name", ["row_stride_not_16_bytes", "base_not_16_byte_aligned",
                                  "heads_broadcast"])
def test_the_backward_copies_what_tma_cannot_address(name):
    """The autograd Function hands the kernels a contiguous copy of such an
    operand (equal values) and every addressable view as it is."""
    t = _refused(name)
    ready = S._kernel_ready(t)
    assert ready.is_contiguous() and torch.equal(ready, t)
    S.tma_geometry(ready)
    for case in CASES:
        view = _case(case)
        assert S._kernel_ready(view) is view


def test_ptxas_lines_name_each_kernel_instance():
    fwd = "_ZN4ssdt17splash_fwd_kernelILi48ELi3EEEv14CUtensorMap_stS1_S1_S1_NS_7FwdArgsE"
    log = "\n".join([
        "== splash_fwd.cu",
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "== splash_bwd.cu",
        "ptxas info    : Compiling entry function "
        "'_ZN4ssdt17splash_dkv_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN4ssdt17splash_dkv_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : 0 bytes gmem"])
    name = "_ZN4ssdt17splash_dkv_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE"
    assert chip_smoke.ptxas_lines(log) == [
        "== splash_fwd.cu",
        f"ptxas {fwd}: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"ptxas {fwd}: Used 168 registers, used 1 barriers",
        "== splash_bwd.cu",
        f"ptxas {name}: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"ptxas {name}: Used 168 registers, used 1 barriers"]


def test_the_wgmma_header_is_its_generators_output():
    """csrc/wgmma.cuh is scripts/gen_wgmma.py's output, one wrapper per N,
    each listing N / 2 accumulator registers."""
    text = gen_wgmma.render()
    assert gen_wgmma.OUT.read_text() == text
    for n in gen_wgmma.WIDTHS:
        body = text[text.index(f"struct Wgmma<{n}> {{"):]
        body = body[:body.index("\n};\n")]
        assert body.count(f"m64n{n}k16.f32.bf16.bf16") == 2
        assert f'"+f"(d[{n // 2 - 1}])' in body and f'"+f"(d[{n // 2}])' not in body
