"""Time launch shapes of the splash dq kernel on one CUDA card.

Run from the repository root, on the card:

    python3 -m scripts.sweep_dq_shapes [--rounds 3] [--dp48 W,K,S,B,T ...]
        [--dp80 W,K,S,B,T ...]

A shape is W warps per CTA, K keys per KV tile, S stages of the KV ring, B
CTAs per SM for ``__launch_bounds__`` and T keys per dP / dS step
(``DqShape`` in ``scal_sdt_tpu_torch/ops/csrc/splash_bwd.cu``). Variant i
takes the i-th shape of each list (the shorter list repeats its last); the
tree's own ``DqShape`` runs as variant "tree". Each variant is a copy of ``ops/csrc``
whose ``DqShape`` gets explicit specializations for DP = 48 and DP = 80,
built (splash_fwd.cu and splash_bwd.cu, every variant at once) into
``ops/build/sweep/``. Then at the main path's shapes (8,8,4096,40) and
(8,8,1024,80) each variant's ``splash_dq`` is held once against the plain
version (dq 1.5e-2 relative, delta 1e-5 of its largest entry) and timed by
CUDA events, the variants in turns, the order reversed every other round.

Prints one line per variant (ptxas registers and spill bytes of the dq
instances, ms per call per round) and writes chiprun_out/sweep_dq_shapes.json.
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

import chip_smoke
from scal_sdt_tpu_torch.ops import _build, splash

SHAPES = {48: (8, 8, 4096, 40), 80: (8, 8, 1024, 80)}
DEFAULT = {48: ["8,64,3,2,32", "8,64,3,2,64", "4,64,3,4,16", "8,32,3,2,16"],
           80: ["8,32,3,2,16", "4,32,3,3,32", "4,32,3,4,16", "4,64,3,2,16"]}
SWEEP_DIR = _build.BUILD_DIR / "sweep"
SPLASH_ENTRIES = ("ssdt_splash_fwd", "ssdt_splash_dq", "ssdt_splash_dkv")


def specialization(dp: int, shape: str) -> str:
    warps, keys, stages, min_blocks, step = (int(x) for x in shape.split(","))
    return (f"template <>\nstruct DqShape<{dp}> {{\n"
            f"  static constexpr int warps = {warps}, keys = {keys}, stages = {stages};\n"
            f"  static constexpr int min_blocks = {min_blocks}, step = {step};\n"
            f"  static constexpr int threads = warps * 32, rows = warps * kWarpRows;\n}};\n")


def make_variant(name: str, shapes: dict[int, str] | None) -> Path:
    """A copy of ops/csrc with DqShape specialized to ``shapes`` (None: as is)."""
    src = SWEEP_DIR / name / "csrc"
    shutil.rmtree(src.parent, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    if shapes:
        path = src / "splash_bwd.cu"
        text = path.read_text()
        primary = re.search(r"struct DqShape \{.*?\n\};\n", text, re.S)
        if primary is None:
            raise RuntimeError("DqShape not found in splash_bwd.cu")
        specs = "".join(specialization(dp, s) for dp, s in sorted(shapes.items()))
        path.write_text(text[:primary.end()] + "\n" + specs + text[primary.end():])
    return src


def build(name: str, csrc: Path) -> tuple[Path, str]:
    out = csrc.parent / f"libsweep_{name}.so"
    return out, _build._compile(out, csrc, ("splash_fwd.cu", "splash_bwd.cu"))


def ptxas_dq(log: str) -> dict[int, dict[str, int]]:
    """Registers and spill bytes of each splash_dq_kernel<DP> in nvcc's -v output."""
    report, dp = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"splash_dq_kernelILi(\d+)E", m.group(1))
            dp = int(k.group(1)) if k else None
            continue
        if dp is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report.setdefault(dp, {})["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report.setdefault(dp, {})["registers"] = int(m.group(1))
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dp48", nargs="+", default=DEFAULT[48])
    parser.add_argument("--dp80", nargs="+", default=DEFAULT[80])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_dq_shapes: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    n = max(len(args.dp48), len(args.dp80))
    pick = lambda xs, i: xs[min(i, len(xs) - 1)]
    variants = {"tree": None}
    for i in range(n):
        shapes = {48: pick(args.dp48, i), 80: pick(args.dp80, i)}
        variants["v%d_%s_%s" % (i, *(s.replace(",", "-") for s in shapes.values()))] = shapes
    srcs = {name: make_variant(name, shapes) for name, shapes in variants.items()}
    with ThreadPoolExecutor(max_workers=4) as pool:
        built = dict(zip(srcs, pool.map(lambda kv: build(*kv), srcs.items())))
    libs = {name: _build.bind(out, SPLASH_ENTRIES) for name, (out, _) in built.items()}
    record = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "variants": {}}
    for name, (_, log) in built.items():
        record["variants"][name] = {"shapes": variants[name], "ptxas": ptxas_dq(log),
                                    "ms": {str(dp): [] for dp in SHAPES}, "err": {}}

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    order = list(libs)
    _build._library = libs["tree"]  # the forward that makes o and lse
    for dp, shape in SHAPES.items():
        qs, k, v, do = (chip_smoke.head_views(shape, gen) for _ in range(4))
        qs = splash._prescale(qs, shape[-1] ** -0.5)
        o, lse = splash.splash_fwd(qs, k, v)
        dq_ref, delta_ref = splash.splash_dq_reference(qs, k, v, o, do, lse)
        for name in order:
            _build._library = libs[name]
            dq, delta = splash.splash_dq(qs, k, v, o, do, lse)
            err = {"dq_rel": chip_smoke.rel_err(dq, dq_ref),
                   "delta_rel": chip_smoke.rel_err(delta, delta_ref)}
            record["variants"][name]["err"][str(dp)] = err
            ok = err["dq_rel"] <= chip_smoke.GRAD_TOL and err["delta_rel"] <= chip_smoke.DELTA_TOL
            chip_smoke.check(ok, f"{name} disagrees at {shape}: {err}")
        del dq_ref, delta_ref, dq, delta
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                _build._library = libs[name]
                ms = chip_smoke.time_ms(lambda: splash.splash_dq(qs, k, v, o, do, lse), iters=20)
                record["variants"][name]["ms"][str(dp)].append(ms)
        del qs, k, v, do, o, lse
        torch.cuda.empty_cache()
    _build._library = None

    for name, rec in record["variants"].items():
        print(f"{name}: ptxas {json.dumps(rec['ptxas'])} ms {json.dumps(rec['ms'])} "
              f"err {json.dumps(rec['err'])}", flush=True)
    chip_smoke.OUT_DIR.mkdir(exist_ok=True)
    (chip_smoke.OUT_DIR / "sweep_dq_shapes.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
