"""One run of one cell: set-up, the measured window, the traced window,
then the comparison with the plain reference.

The order is fixed: the kind's set-up (weights and inputs from the seed, the
program built once and driven through its first units, which warms every
shape the window uses), ``setup_s`` read; the peak memory counter reset and
the window run for ``seconds`` (whole units, ending in a synchronize: the
rate is all the window's work over all its time); the peak read; with
``trace`` a profiled window of a few more units for the per-layer readers;
the program's readings taken and its state freed; the reference run over
the same inputs; each number compared with its limit.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch

from benchmark.harness import peaks, trace as tracing
from benchmark.harness.spec import Cell
from benchmark.reference.numerics import Numerics, no_tf32


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""
    cell: Cell
    family: object
    work: object
    trace: tracing.Trace
    window: dict          # units, images, seconds of the measured window
    peaks: dict | None    # the card's peak rates, None where the table has none


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_work(cell: Cell, seed: int, device, fault: str | None = None):
    family = cell.module("families", cell.config["family"])
    kind = cell.module("kinds", cell.traffic["kind"])
    return kind.Work(cell, seed, device, family, fault), family


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             fault: str | None = None, started: float | None = None) -> dict:
    """The result of one run (the contract's keys, ``checks`` last)."""
    started = time.perf_counter() if started is None else started
    cuda = torch.device(device).type == "cuda"
    work, family = make_work(cell, seed, device, fault)
    work.setup()
    synchronize(device)
    setup_s = time.perf_counter() - started

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    units, t0 = 0, time.perf_counter()
    while units == 0 or time.perf_counter() - t0 < seconds:
        work.unit()
        units += 1
    synchronize(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window = {"units": units, "images": units * work.images_per_unit, "seconds": window_s}
    e2e = {work.rate_name: window["images"] / window_s, "peak_mem_gib": peak / 2 ** 30,
           "setup_s": setup_s}

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": window["images"], "failed": 0}
    phases = {"setup": setup_s, "window": window_s}
    if trace:
        t0 = time.perf_counter()
        tr = tracing.record(work.unit, work.trace_units)
        ctx = Context(cell, family, work, tr, window,
                      peaks.of(device_info["kind"]) if cuda else None)
        metrics = {}
        for m in cell.per_layer:
            value = cell.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = tr.breakdown()
        phases["trace"] = time.perf_counter() - t0
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise KeyError(f"the {cell.traffic['kind']} kind measures no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        breakdown = None

    prog = work.program_readings()
    work.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with no_tf32():
        ref = work.reference_readings(Numerics("fp32"))
    phases["reference"] = time.perf_counter() - t0
    numbers = work.numbers(prog, ref)
    checks = check_numbers(numbers, cell.limits)
    failed = sum(not c["ok"] for c in checks.values())
    result.update(correct=bool(checks) and failed == 0, failed=failed, metrics=metrics,
                  device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["phases_s"] = {**getattr(work, "phases", {}), **phases}
    if hasattr(work, "explain"):
        result["explain"] = work.explain(prog, ref)
    result["readings"] = numbers
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


def check_numbers(numbers: dict, limits: dict) -> dict:
    """Each number that has a limit, with it, and whether it holds (a
    number that is not finite never holds)."""
    out = {}
    for name, entry in limits.items():
        value = numbers[name]
        out[name] = {"value": value, "limit": entry["limit"],
                     "ok": math.isfinite(value) and value <= entry["limit"]}
    return out
