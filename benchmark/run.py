"""The benchmark of the PyTorch and CUDA port (``scal_sdt_tpu_torch``).

Run from the root of a checkout, on a machine with the cards the cell asks
for:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It runs the cell of ``BENCHMARK.json`` once: set-up from the seed, a window
of ``--seconds``, with ``--trace 1`` a profiled window for the per-layer
metrics, then the comparison with the plain reference that decides
``correct``. The last line of standard output is the result as one JSON
object; the last lines of standard error give each compared number beside
its limit. It exits with 2 and prints no result where the cell's cards are
not there, and with 3 where a module of JAX, Flax or the JAX package was
loaded by the time the window closed.

Build and kernel caches stay inside the checkout: the port's CUDA library in
its ``ops/build/`` and, should anything of PyTorch compile, ``.cache/`` at
the root of the checkout.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "scal_sdt_tpu", "lab")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``scal_sdt_tpu_torch`` is not ``scal_sdt_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def finite(value):
    return value if not isinstance(value, float) or math.isfinite(value) else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        os.environ[var] = str(ROOT / ".cache" / var.lower())
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.runner import run_cell
    from benchmark.harness.spec import resolve

    cell = resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      started=STARTED)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    result["readings"] = {k: finite(v) for k, v in result["readings"].items()}
    for c in result["checks"].values():
        c["value"] = finite(c["value"])
    print(json.dumps(result))
    sys.stdout.flush()
    for name, value in result["readings"].items():
        if name not in result["checks"]:
            print(f"{name} {value} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
