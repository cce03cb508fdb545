"""Time the splash backward pair (splash_dq, splash_dkv) of the tree in the
current directory at every backward form chip_smoke.py times, for an A/B of
two trees on one card.

Run on the card from the root of each tree, one process per turn, for
example parent, change, change, parent with the parent unpacked into a
directory that .gitignore lists:

    git archive <parent> | tar -x -C tree_check/parent
    for side in parent change change parent; do
      dir=.; [ $side = parent ] && dir=tree_check/parent
      (cd $dir && python3 $OLDPWD/scripts/ab_splash_bwd.py $side)
    done

Imports the package and chip_smoke.py of the current directory, so it runs
against any tree whose splash wrappers take (qs, k, v, o, do, lse) and (qs,
k, v, do, lse, delta). Per form: ms per call of dq, dkv and the pair (dq
then dkv on its delta) by CUDA events, whether a second launch of each gives
the same bits, each kernel's device ms with its calls queued behind a spin
kernel, and each wrapper's host microseconds per call. Prints the card's
name and power limit and one JSON line per form, and writes
ab_splash_bwd_<tag>.json into $AB_OUT (default: the current tree's
chip_smoke.py output directory).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from scal_sdt_tpu_torch.ops import _build, splash  # noqa: E402

# the lora cell's forms at its ARB buckets (chip_smoke.py's lora phase)
LORA_FORMS = [(4, 8, 5632, 40), (4, 8, 1408, 80)]


def forms() -> list[tuple[int, int, int, int]]:
    out = (list(chip_smoke.MAIN_SHAPES) + [chip_smoke.ARB_SHAPE] + LORA_FORMS
           + list(chip_smoke.SDXL_KERNEL_SHAPES) + list(chip_smoke.SD3_KERNEL_SHAPES)
           + list(chip_smoke.SD21_KERNEL_SHAPES) + [chip_smoke.PARALLEL_TP_SHAPE])
    return list(dict.fromkeys(tuple(f) for f in out))


def host_us(fn, iters: int = 20) -> float:
    """Host time per call of fn() in microseconds: issuing only, the device
    held busy by a spin kernel meanwhile."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / iters * 1e6


def main() -> int:
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    if not torch.cuda.is_available():
        print("ab_splash_bwd: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{tag}: {smi}", flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    record = {"tag": tag, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "build_s": time.perf_counter() - t0, "forms": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in forms():
        q, k, v, do = (chip_smoke.head_views(shape, gen) for _ in range(4))
        qs = splash._prescale(q, shape[-1] ** -0.5)
        o, lse = splash.splash_fwd(qs, k, v)
        first = splash.splash_dq(qs, k, v, o, do, lse)
        first += splash.splash_dkv(qs, k, v, do, lse, first[1])
        again = splash.splash_dq(qs, k, v, o, do, lse)
        again += splash.splash_dkv(qs, k, v, do, lse, again[1])
        r = {"dq_ms": chip_smoke.time_ms(lambda: splash.splash_dq(qs, k, v, o, do, lse),
                                         iters=20, warmup=3),
             "dkv_ms": chip_smoke.time_ms(
                 lambda: splash.splash_dkv(qs, k, v, do, lse, first[1]), iters=20, warmup=3),
             "pair_ms": chip_smoke.time_ms(
                 lambda: splash.splash_dkv(qs, k, v, do, lse,
                                           splash.splash_dq(qs, k, v, o, do, lse)[1]),
                 iters=20, warmup=3),
             "same_bits": all(torch.equal(a, b) for a, b in zip(first, again)),
             # queued behind a spin kernel: the device's time alone
             "dq_device_ms": chip_smoke.device_ms(
                 lambda: splash.splash_dq(qs, k, v, o, do, lse), iters=20),
             "dkv_device_ms": chip_smoke.device_ms(
                 lambda: splash.splash_dkv(qs, k, v, do, lse, first[1]), iters=20),
             "dq_host_us": host_us(lambda: splash.splash_dq(qs, k, v, o, do, lse)),
             "dkv_host_us": host_us(lambda: splash.splash_dkv(qs, k, v, do, lse, first[1]))}
        record["forms"][str(list(shape))] = r
        print(f"{tag} {list(shape)} {json.dumps(r)}", flush=True)
        del q, k, v, do, qs, o, lse, first, again
        torch.cuda.empty_cache()
    out = os.path.join(os.environ.get("AB_OUT", str(chip_smoke.OUT_DIR)), f"ab_splash_bwd_{tag}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
