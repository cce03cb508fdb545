"""Write ``scal_sdt_tpu_torch/ops/csrc/wgmma.cuh``: the warpgroup products
(``wgmma.mma_async``, bf16 in, fp32 accumulate) the splash kernels issue,
one wrapper per N, since a wgmma lists its N / 2 accumulator registers in
the instruction itself.

    python3 -m scripts.gen_wgmma

``Wgmma<N>::ss<TB>`` takes A and B from shared memory by descriptor;
``Wgmma<N>::rs<TB>`` takes A from four registers per thread (one k16
fragment) and B by descriptor. TB = 1 reads B transposed (MN-major).
"""

from __future__ import annotations

from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "scal_sdt_tpu_torch" / "ops" / "csrc" / "wgmma.cuh"
WIDTHS = (16, 32, 48, 64, 80, 96, 128, 160)  # every N the kernels use

HEAD = """// Generated by scripts/gen_wgmma.py; edit that script, not this file.
//
// wgmma.mma_async m64nNk16, bf16 in, fp32 accumulate, for each N of
// WIDTHS: ss (A and B by shared-memory descriptor) and rs (A from a k16
// register fragment). scale_d = 0 overwrites the accumulator, 1 adds to it.
// TB = 1 reads B MN-major (transposed). Each call must sit between
// wgmma_fence() and wgmma_commit() (splash_hopper.cuh).

#pragma once

#include <stdint.h>

namespace ssdt {

template <int N>
struct Wgmma;
"""


def _regs(first: int, count: int, per_line: int = 8) -> str:
    names = [f"%{first + i}" for i in range(count)]
    lines = [", ".join(names[i:i + per_line]) for i in range(0, count, per_line)]
    return ",\\n\"\n      \"".join(lines)


def _outs(count: int, per_line: int = 4) -> str:
    items = [f'"+f"(d[{i}])' for i in range(count)]
    lines = [", ".join(items[i:i + per_line]) for i in range(0, count, per_line)]
    return ",\n        ".join(lines)


def wrapper(n: int) -> str:
    nd = n // 2
    ss = (f"  template <int TB>\n"
          f"  static __device__ __forceinline__ void ss(float (&d)[{nd}], uint64_t a, uint64_t b,\n"
          f"                                            int scale_d) {{\n"
          f"    asm volatile(\n"
          f"      \"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 2}, 0;\\n\"\n"
          f"      \"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{\"\n"
          f"      \"{_regs(0, nd)}}}, \"\n"
          f"      \"%{nd}, %{nd + 1}, p, 1, 1, 0, %{nd + 3};\\n}}\\n\"\n"
          f"        : {_outs(nd)}\n"
          f"        : \"l\"(a), \"l\"(b), \"r\"(scale_d), \"n\"(TB));\n"
          f"  }}\n")
    rs = (f"  template <int TB>\n"
          f"  static __device__ __forceinline__ void rs(float (&d)[{nd}], const uint32_t (&a)[4],\n"
          f"                                            uint64_t b, int scale_d) {{\n"
          f"    asm volatile(\n"
          f"      \"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 5}, 0;\\n\"\n"
          f"      \"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{\"\n"
          f"      \"{_regs(0, nd)}}}, \"\n"
          f"      \"{{%{nd}, %{nd + 1}, %{nd + 2}, %{nd + 3}}}, %{nd + 4}, p, 1, 1, %{nd + 6};\\n}}\\n\"\n"
          f"        : {_outs(nd)}\n"
          f"        : \"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), \"l\"(b), \"r\"(scale_d),\n"
          f"          \"n\"(TB));\n"
          f"  }}\n")
    return f"\ntemplate <>\nstruct Wgmma<{n}> {{\n{ss}{rs}}};\n"


def render() -> str:
    return HEAD + "".join(wrapper(n) for n in WIDTHS) + "\n}  // namespace ssdt\n"


def main() -> int:
    OUT.write_text(render())
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
