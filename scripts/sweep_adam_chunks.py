"""Time the grouped optimizer launches at several chunk sizes, on one CUDA card.

Run from the repository root, on the card:

    python3 -m scripts.sweep_adam_chunks [--chunks 2048,4096,8192,16384]
                                         [--steps 1,2,4,8] [--rounds 3]
                                         [--int8-min-ctas 3,4]

Over the 686 SD1.5 UNet leaves (bf16 masters), it builds AdamW's leaf table
(bf16 moments) for each ``--chunks`` value (elements per CTA of
``adam_bf16_fused``'s grouped launch, ``ops/adam_bf16_fused.CHUNK``) and
AdamW8bit's int8 leaf table for each ``--steps`` value (steps of 16 blocks
per CTA of ``adam8_fused``'s, ``ops/adam8_fused.CHUNK_STEPS``), and times
each launch's device time (torch.profiler) in ``--rounds`` rounds, the
variants in turns. Before timing, each variant's first launch is held bit
for bit against the committed chunk size's from the same state.

``--int8-min-ctas N,...`` adds variants of ``adam8_fused``'s grouped kernel
built with ``__launch_bounds__(256, N)`` (at least N CTAs per SM, which caps
its registers; ``kGroupMinCtas`` in the tree): each is a copy of ``ops/csrc``
with that one change, built
into ``ops/build/sweep/`` (one nvcc per source, the variants at once), timed
at the committed chunk size beside the tree's build and held bit for bit
against it. Prints one line per variant with its times and its share of the
bytes bound (and ptxas's registers and spills for the built variants), and
writes chiprun_out/sweep_adam_chunks.json.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from scal_sdt_tpu_torch.ops import _build
from scal_sdt_tpu_torch.ops import adam8_fused as A8
from scal_sdt_tpu_torch.ops import adam_bf16_fused as AF
from scal_sdt_tpu_torch.training.quantized import Adam8bit, bias_corrections

SWEEP_DIR = _build.BUILD_DIR / "sweep"
MIN_CTAS = re.compile(r"constexpr int kGroupMinCtas = \d+;")


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def adamw_variants(gen, keys, shapes, chunks: list[int]) -> dict:
    """{chunk: (run, table)} of AdamW's grouped launch, each on its own copy
    of one state."""
    params = [cs.rand(s, gen, 2e-2) for s in shapes]
    mu = [cs.rand(s, gen, 1e-4) for s in shapes]
    nu = [cs.rand(s, gen, 1e-7, positive=True) for s in shapes]
    grads = [cs.rand(s, gen, 1e-3) for s in shapes]
    steps = [AF.GroupStep(bias_corrections(cs.B1, cs.B2, 3), 3, cs.GROUP_WD,
                          cs.GROUP_STEP_SIZE)]
    kw = dict(b1=cs.B1, b2=cs.B2, eps=cs.EPS, recip_bc=False, step=2,
              update_dtype=torch.float32)
    out = {}
    for c in chunks:
        AF.CHUNK = c
        table = AF.build_adam_table([keys], cs.clones(params), cs.clones(mu), cs.clones(nu))

        def run(table=table, c=c):
            AF.CHUNK = c
            AF.adam_bf16_fused_apply(table, grads, steps, **kw)

        out[c] = (run, table)
    return out


def adam8_variants(gen, keys, shapes, steps: dict) -> dict:
    """{key: (run, table)} of AdamW8bit's int8 grouped launch at ``steps[key]``
    steps per chunk, each on its own copy of one (zero) state."""
    params = {k: cs.rand(s, gen, 2e-2) for k, s in zip(keys, shapes)}
    state = Adam8bit(cs.B1, cs.B2, cs.EPS).init(params)
    k8 = [k for k in keys if k in state.mu_s]
    grads = [cs.rand(params[k].shape, gen, 1e-3) for k in k8]
    inv = [float(1 / b) for b in bias_corrections(cs.B1, cs.B2, 1)]
    hp = dict(b1=cs.B1, b2=cs.B2, eps=cs.EPS, step=0, weight_decay=cs.GROUP_WD,
              step_size=cs.GROUP_STEP_SIZE)
    out = {}
    for key, n in steps.items():
        A8.CHUNK_STEPS, A8.CHUNK_BLOCKS = n, 16 * n
        table = A8.build_adam8_table(
            k8, [params[k].clone() for k in k8],
            [tuple(t.clone() for t in (state.mu_q[k], state.mu_s[k], state.nu_q[k],
                                       state.nu_s[k])) for k in k8])

        def run(table=table, n=n):
            A8.CHUNK_STEPS, A8.CHUNK_BLOCKS = n, 16 * n
            A8.adam8_fused_apply(table, grads, *inv, **hp)

        out[key] = (run, table)
    return out


def build_min_ctas(n: int) -> tuple[object, str]:
    """The library built from a copy of ops/csrc whose grouped int8 kernel
    asks for ``n`` CTAs per SM; returns it and ptxas's report of that
    kernel."""
    src = SWEEP_DIR / f"int8_min{n}" / "csrc"
    shutil.rmtree(src.parent, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    path = src / "adam8_fused.cu"
    text, found = MIN_CTAS.subn(f"constexpr int kGroupMinCtas = {n};", path.read_text())
    if found != 1:
        raise RuntimeError("kGroupMinCtas not found in adam8_fused.cu")
    path.write_text(text)
    out = src.parent / f"libsweep_int8_min{n}.so"
    log = _build._compile(out, src, ("splash_fwd.cu", "adam8_fused.cu"))
    lines = log.splitlines()
    report = " | ".join(" ".join(x.strip() for x in lines[i + 1:i + 4]
                                 if "Used" in x or "spill" in x)
                        for i, line in enumerate(lines)
                        if re.search(r"Compiling entry function '\S*adam8_group", line))
    return _build.bind(out, ("ssdt_adam8_group",)), report


def sweep_min_ctas(gen, keys, shapes, ns: list[int], rounds: int) -> dict:
    """The tree's grouped int8 kernel against its launch-bounds variants."""
    with ThreadPoolExecutor(len(ns)) as pool:
        built = dict(zip(ns, pool.map(build_min_ctas, ns)))
    tree = _build.load_library()
    libs = {"tree": tree, **{f"min{n}": lib for n, (lib, _) in built.items()}}
    variants = {}
    runs = adam8_variants(gen, keys, shapes, {name: A8.CHUNK_STEPS for name in libs})
    for name, (run, table) in runs.items():

        def run_with(run=run, lib=libs[name]):
            _build._library = lib
            try:
                run()
            finally:
                _build._library = tree

        variants[name] = (run_with, table)
    res = sweep("adam8_group build", variants, "tree", "adam8_group", rounds)
    for n, (_, report) in built.items():
        res["variants"][f"min{n}"]["ptxas"] = report
        print(f"adam8_group build min{n} ptxas: {report}", flush=True)
    return res


def sweep(name: str, variants: dict, committed, kernel: str, rounds: int) -> dict:
    """First launch of each variant against the committed one's, bit for
    bit; then device times in turns."""
    for run, _ in variants.values():
        run()
    torch.cuda.synchronize()
    ref = variants[committed][1]

    def tensors(t):
        return list(t.params) + ([x for s in t.state for x in s] if hasattr(t, "state")
                                 else list(t.mu) + list(t.nu))

    for key, (_, table) in variants.items():
        same = all(torch.equal(a, b) for a, b in zip(tensors(table), tensors(ref)))
        cs.check(same, f"{name}: chunk {key} differs from chunk {committed}")
    nbytes = cs.group_bytes(ref)
    bound_ms = nbytes / cs.PEAK_HBM_BYTES_PER_S * 1e3
    times = {key: [] for key in variants}
    for _ in range(rounds):
        for key, (run, _) in variants.items():
            times[key].append(cs.kernel_device_ms(run, kernel))
    res = {"bytes": nbytes, "bound_ms": bound_ms,
           "variants": {str(k): {"ms": v, "chunks": len(variants[k][1].chunks),
                                 "of_bound": bound_ms / min(v)} for k, v in times.items()}}
    for k, v in res["variants"].items():
        print(f"{name} {k}: {json.dumps(v)}", flush=True)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--chunks", type=_ints, default=[2048, 4096, 8192, 16384])
    parser.add_argument("--steps", type=_ints, default=[1, 2, 4, 8])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--int8-min-ctas", type=_ints, default=[])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_adam_chunks: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    chunk0, steps0 = AF.CHUNK, A8.CHUNK_STEPS
    gen = torch.Generator(device="cuda").manual_seed(0)
    keys, shapes = cs.sd15_leaves()
    result = {"device": smi, "committed": {"chunk": chunk0, "steps": steps0}}
    result["adam_bf16_group"] = sweep(
        "adam_bf16_group chunk",
        adamw_variants(gen, keys, shapes, sorted({chunk0, *args.chunks})),
        chunk0, "adam_bf16_group", args.rounds)
    AF.CHUNK = chunk0
    torch.cuda.empty_cache()
    result["adam8_group"] = sweep(
        "adam8_group steps",
        adam8_variants(gen, keys, shapes, {n: n for n in sorted({steps0, *args.steps})}),
        steps0, "adam8_group", args.rounds)
    A8.CHUNK_STEPS, A8.CHUNK_BLOCKS = steps0, 16 * steps0
    if args.int8_min_ctas:
        torch.cuda.empty_cache()
        result["adam8_group_min_ctas"] = sweep_min_ctas(gen, keys, shapes, args.int8_min_ctas,
                                                        args.rounds)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "sweep_adam_chunks.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
