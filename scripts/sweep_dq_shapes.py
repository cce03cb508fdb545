"""Time launch shapes of the splash kernels (the forward, dq and dkv) on one CUDA card.

Run from the repository root, on the card:

    python3 -m scripts.sweep_dq_shapes [--rounds 3] [--variant SPEC ...]

A SPEC is a space-separated list of items KERNEL DP=FIELDS, for example
"fwd48=3,128,4 dq48=3,64,3 dkv48=2,64,3,1". The fields are those of the
kernel's shape struct: for ``FwdShape`` (``splash_fwd.cu``) consumer
warpgroups, keys per K/V tile and stages of the ring; for ``DqShape``
(``splash_bwd.cu``) consumer warpgroups, keys per K/V tile and stages; for
``DkvShape`` consumer warpgroups, queries per q/dO tile, stages and a_regs
(0 or 1: k and v, the A operands of the score products, in registers). Each
variant is a copy of ``ops/csrc`` whose sources get one explicit
specialization per item right after the primary template (a forward item
also sets both of ``FwdConsumers``' counts to its consumers, so every grid
runs that one shape); the tree's own shapes run as variant "tree". All variants are built at once (splash_fwd.cu and splash_bwd.cu)
into ``ops/build/sweep/``. Then at the form of every head dim a variant
names (``FORMS``: SD1.5's (8,8,4096,40) and (8,8,1024,80), SD3's
(2,24,4250,64)) each variant's ``splash_fwd``, ``splash_dq`` and
``splash_dkv`` are held once against the plain versions (O 5e-3 max-abs,
lse 1e-4, gradients 1.5e-2 relative, delta 1e-5 of its largest entry) and
timed by CUDA events, the variants in turns, the order reversed every other
round; a variant that disagrees is reported and not timed at that form.

Prints one line per variant (ptxas registers and spill bytes of each
kernel's instances, ms per call per round) and writes sweep_dq_shapes.json
into chip_smoke.py's output directory.
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

FORMS = {48: (8, 8, 4096, 40), 64: (2, 24, 4250, 64), 80: (8, 8, 1024, 80)}
DEFAULT = ["fwd48=3,128,4 fwd64=4,64,4 fwd80=3,64,3",
           "fwd48=2,128,4 fwd64=3,128,4 fwd80=2,64,3"]
SWEEP_DIR = _build.BUILD_DIR / "sweep"
SPLASH_ENTRIES = ("ssdt_splash_fwd", "ssdt_splash_dq", "ssdt_splash_dkv")
# kernel -> (shape struct, its source, its tile field, its flags in spec order)
STRUCTS = {"fwd": ("FwdShape", "splash_fwd.cu", "keys", ()),
           "dq": ("DqShape", "splash_bwd.cu", "keys", ()),
           "dkv": ("DkvShape", "splash_bwd.cu", "queries", ("a_regs",))}


def parse_spec(spec: str) -> dict[tuple[str, int], str]:
    """"dq48=3,64,3 dkv80=2,64,3,1" -> {("dq", 48): "3,64,3",
    ("dkv", 80): "2,64,3,1"}."""
    out = {}
    for item in spec.split():
        m = re.fullmatch(r"(fwd|dq|dkv)(\d+)=(\d+),(\d+),(\d+)((?:,[01])*)", item)
        if m is None or len(m.group(6)) // 2 != len(STRUCTS[m.group(1)][3]):
            raise ValueError(f"bad variant item {item!r} (want e.g. fwd48=3,128,4, "
                             f"dq48=3,64,3 or dkv48=2,64,3,1)")
        out[(m.group(1), int(m.group(2)))] = ",".join(m.groups()[2:5]) + m.group(6)
    return out


def specialization(kernel: str, dp: int, fields: str) -> str:
    struct, _, tile, flags = STRUCTS[kernel]
    consumers, rows, stages, *values = fields.split(",")
    bools = ", ".join(f"{f} = {'true' if v == '1' else 'false'}" for f, v in zip(flags, values))
    if kernel == "fwd":  # one launch shape for every grid: FwdShape<dp, consumers>
        return (f"template <>\nstruct FwdConsumers<{dp}> {{\n"
                f"  static constexpr int wide = {consumers}, narrow = {consumers};\n}};\n"
                f"template <>\nstruct FwdShape<{dp}, {consumers}> {{\n"
                f"  static constexpr int consumers = {consumers}, {tile} = {rows}, "
                f"stages = {stages};\n"
                f"  static constexpr int rows = consumers * kGroupRows, "
                f"threads = (consumers + 1) * 128;\n}};\n")
    return (f"template <>\nstruct {struct}<{dp}> {{\n"
            f"  static constexpr int consumers = {consumers}, {tile} = {rows}, "
            f"stages = {stages};\n"
            + (f"  static constexpr bool {bools};\n" if bools else "") +
            f"  static constexpr int rows = consumers * kGroupRows, "
            f"threads = (consumers + 1) * 128;\n}};\n")


def make_variant(name: str, items: dict[tuple[str, int], str] | None) -> Path:
    """A copy of ops/csrc with FwdShape / DqShape / DkvShape specialized to
    ``items`` (None: as is)."""
    src = SWEEP_DIR / name / "csrc"
    shutil.rmtree(src.parent, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    for kernel, (struct, source, _, _) in (STRUCTS.items() if items else ()):
        specs = "".join(specialization(k, dp, f) for (k, dp), f in sorted(items.items())
                        if k == kernel)
        if not specs:
            continue
        path = src / source
        text = path.read_text()
        primary = re.search(rf"struct {struct} \{{.*?\n\}};\n", text, re.S)
        if primary is None:
            raise RuntimeError(f"{struct} not found in {source}")
        path.write_text(text[:primary.end()] + "\n" + specs + text[primary.end():])
    return src


def build(name: str, csrc: Path) -> tuple[Path, str]:
    out = csrc.parent / f"libsweep_{name}.so"
    return out, _build._compile(out, csrc, ("splash_fwd.cu", "splash_bwd.cu"))


def ptxas(log: str, kernel: str) -> dict[int | str, dict[str, int]]:
    """Registers and spill bytes of each splash_{kernel}_kernel instance in
    nvcc's -v output (kernel "fwd", "dq" or "dkv"), keyed by its DP, or
    "DP/NC" for the forward's instance of NC consumers."""
    report, dp = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(rf"splash_{kernel}_kernelILi(\d+)E(?:Li(\d+)E)?", m.group(1))
            dp = None if k is None else (f"{k.group(1)}/{k.group(2)}" if k.group(2)
                                         else int(k.group(1)))
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
    parser.add_argument("--variant", action="append", help="KERNEL DP=FIELDS items")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_dq_shapes: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    variants = {"tree": None}
    for i, spec in enumerate(args.variant or DEFAULT):
        variants[f"v{i}"] = parse_spec(spec)
    dps = sorted({dp for items in variants.values() if items for _, dp in items} or FORMS)
    srcs = {name: make_variant(name, items) for name, items in variants.items()}
    with ThreadPoolExecutor(max_workers=4) as pool:
        built = dict(zip(srcs, pool.map(lambda kv: build(*kv), srcs.items())))
    libs = {name: _build.bind(out, SPLASH_ENTRIES) for name, (out, _) in built.items()}
    record = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "variants": {}}
    for name, (_, log) in built.items():
        record["variants"][name] = {
            "items": {f"{k}{dp}": f for (k, dp), f in (variants[name] or {}).items()},
            "ptxas": {k: ptxas(log, k) for k in STRUCTS},
            "ms": {f"{k}{dp}": [] for dp in dps for k in STRUCTS}, "err": {}}

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    order = list(libs)
    for dp in dps:
        shape = FORMS[dp]
        qs, k, v, do = (chip_smoke.head_views(shape, gen) for _ in range(4))
        qs = splash._prescale(qs, shape[-1] ** -0.5)
        # the plain forward's o and lse feed every variant's backward
        o, lse = splash.splash_fwd_reference(qs, k, v)
        dq_ref, delta_ref = splash.splash_dq_reference(qs, k, v, o, do, lse)
        dk_ref, dv_ref = splash.splash_dkv_reference(qs, k, v, do, lse, delta_ref)
        agree = []
        for name in order:
            _build._library = libs[name]
            o_k, lse_k = splash.splash_fwd(qs, k, v)
            dq, delta = splash.splash_dq(qs, k, v, o, do, lse)
            dk, dv = splash.splash_dkv(qs, k, v, do, lse, delta)
            err = {"fwd": chip_smoke.max_abs(o_k, o), "lse": chip_smoke.max_abs(lse_k, lse),
                   "dq_rel": chip_smoke.rel_err(dq, dq_ref),
                   "delta_rel": chip_smoke.rel_err(delta, delta_ref),
                   "dkv_rel": max(chip_smoke.rel_err(dk, dk_ref), chip_smoke.rel_err(dv, dv_ref))}
            record["variants"][name]["err"][str(dp)] = err
            if (err["fwd"] <= chip_smoke.FWD_TOL and err["lse"] <= chip_smoke.LSE_TOL
                    and max(err["dq_rel"], err["dkv_rel"]) <= chip_smoke.GRAD_TOL
                    and err["delta_rel"] <= chip_smoke.DELTA_TOL):
                agree.append(name)
            else:
                print(f"{name} disagrees at {shape}: {err}", flush=True)
        del dq_ref, dk_ref, dv_ref, dq, dk, dv, o_k, lse_k
        delta = delta_ref  # the plain version's, for every variant's dkv timing
        for r in range(args.rounds):
            for name in (agree if r % 2 == 0 else agree[::-1]):
                _build._library = libs[name]
                ms = record["variants"][name]["ms"]
                ms[f"fwd{dp}"].append(chip_smoke.time_ms(
                    lambda: splash.splash_fwd(qs, k, v), iters=20))
                ms[f"dq{dp}"].append(chip_smoke.time_ms(
                    lambda: splash.splash_dq(qs, k, v, o, do, lse), iters=20))
                ms[f"dkv{dp}"].append(chip_smoke.time_ms(
                    lambda: splash.splash_dkv(qs, k, v, do, lse, delta), iters=20))
        del qs, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    _build._library = None

    for name, rec in record["variants"].items():
        print(f"{name} {json.dumps(rec['items'])}: ptxas {json.dumps(rec['ptxas'])} "
              f"ms {json.dumps(rec['ms'])} err {json.dumps(rec['err'])}", flush=True)
    chip_smoke.OUT_DIR.mkdir(exist_ok=True)
    (chip_smoke.OUT_DIR / "sweep_dq_shapes.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
