"""Time the splash forward (splash_fwd) of the tree in the current directory at
every form chip_smoke.py runs it in, for an A/B of two trees on one card.

Run on the card from the root of each tree, one process per turn, for
example parent, change, change, parent with the parent unpacked into a
directory that .gitignore lists:

    git archive <parent> | tar -x -C tree_check/parent
    for side in parent change change parent; do
      dir=.; [ $side = parent ] && dir=tree_check/parent
      (cd $dir && python3 $OLDPWD/scripts/ab_splash_fwd.py $side)
    done

Imports the package and chip_smoke.py of the current directory, so it runs
against any tree whose ``splash_fwd`` takes (qs, k, v). Per form (the
backward's forms of ``ab_splash_bwd.forms`` and sampling's): ms per call by
CUDA events, the device's time alone with the calls queued behind a spin
kernel, the wrapper's host microseconds per call, SDPA's forward by both
clocks, the error against the plain version and whether a second launch
gives the same bits. Prints the card's name and power limit and one JSON
line per form, and writes ab_splash_fwd_<tag>.json into $AB_OUT (default:
the current tree's chip_smoke.py output directory).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from scal_sdt_tpu_torch.ops import _build, splash  # noqa: E402
from scripts.ab_splash_bwd import forms as bwd_forms, host_us  # noqa: E402


def forms() -> list[tuple[int, int, int, int]]:
    out = bwd_forms() + list(chip_smoke.SAMPLING_SHAPES) + list(chip_smoke.SDXL_SAMPLING_SHAPES)
    return list(dict.fromkeys(tuple(f) for f in out))


def main() -> int:
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    if not torch.cuda.is_available():
        print("ab_splash_fwd: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{tag}: {smi}", flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    record = {"tag": tag, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "build_s": time.perf_counter() - t0, "forms": {}}
    rate = chip_smoke.exp_rate()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in forms():
        b, h, l, d = shape
        q, k, v = (chip_smoke.head_views(shape, gen) for _ in range(3))
        qs = splash._prescale(q, d ** -0.5)
        o, lse = splash.splash_fwd(qs, k, v)
        o2, lse2 = splash.splash_fwd(qs, k, v)
        o_ref, lse_ref = splash.splash_fwd_reference(qs, k, v)

        def fwd():
            splash.splash_fwd(qs, k, v)

        def sdpa():
            F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)

        r = {"err": chip_smoke.max_abs(o, o_ref), "lse_err": chip_smoke.max_abs(lse, lse_ref),
             "same_bits": torch.equal(o, o2) and torch.equal(lse, lse2),
             "ms": chip_smoke.time_ms(fwd, iters=20, warmup=3),
             "device_ms": chip_smoke.device_ms(fwd, iters=20),
             "host_us": host_us(fwd),
             "sdpa_ms": chip_smoke.time_ms(sdpa, iters=20, warmup=3),
             "sdpa_device_ms": chip_smoke.device_ms(sdpa, iters=20),
             "bound_ms": chip_smoke.bounds_ms(b, h, l, l, d, *rate)["splash_fwd"][0]}
        r["device_over_sdpa"] = r["device_ms"] / r["sdpa_device_ms"]
        r["bound_share"] = r["bound_ms"] / r["device_ms"]
        record["forms"][str(list(shape))] = r
        print(f"{tag} {list(shape)} {json.dumps(r)}", flush=True)
        del q, k, v, qs, o, lse, o2, lse2, o_ref, lse_ref
        torch.cuda.empty_cache()
    out = os.path.join(os.environ.get("AB_OUT", str(chip_smoke.OUT_DIR)), f"ab_splash_fwd_{tag}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
