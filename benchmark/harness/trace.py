"""A ``torch.profiler`` window over a few units of a cell's work, reduced to
what the per-layer readers and the result line take.

``Trace`` holds the device operations (kernels, copies, sets) as (name,
start, duration) in seconds, the host's operations that had no parent
(top-level ``aten::`` calls and autograd nodes), the window's host-clock
length and the units of work it ran. ``busy_s`` is the union of the device
operations' intervals; each stretch of the window with no device operation
is put down to the top-level host operation under its midpoint, or to the
host outside any operation.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

TOP = 10        # entries per list of the result's breakdown
LOOKBACK = 64   # host operations before a gap's midpoint that may cover it
WINDOW = "benchmark_window"   # the host's range around the traced units (and its device echo)


@dataclasses.dataclass
class Trace:
    device_ops: list          # (name, start_s, dur_s), sorted by start
    host_ops: list            # (name, start_s, dur_s) of top-level host operations
    window_s: float           # host clock over the traced units, ending in a synchronize
    units: int                # units of work traced (steps, batches)
    start_s: float            # the window's start on the trace's clock

    def kernels(self, *patterns: str) -> list:
        """Device kernels whose name holds any of ``patterns`` (all without)."""
        ops = [op for op in self.device_ops if not op[0].startswith(("Memcpy", "Memset"))]
        if not patterns:
            return ops
        return [op for op in ops if any(p in op[0] for p in patterns)]

    def busy_intervals(self) -> list:
        merged: list[list[float]] = []
        for _, start, dur in self.device_ops:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], start + dur)
            else:
                merged.append([start, start + dur])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> dict[str, float]:
        """Seconds of the window with no device operation, by host operation."""
        gaps: dict[str, float] = {}
        edges = [self.start_s] + [x for iv in self.busy_intervals() for x in iv] \
            + [self.start_s + self.window_s]
        host = sorted(self.host_ops, key=lambda op: op[1])
        starts = [op[1] for op in host]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            name = "host outside any operation"
            i = bisect.bisect_right(starts, mid) - 1
            for op_name, start, dur in reversed(host[max(0, i - LOOKBACK):i + 1]):
                if start + dur >= mid:
                    name = op_name
                    break
            gaps[name] = gaps.get(name, 0.0) + (b - a)
        return gaps

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for name, _, dur in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:64], s] for n, s in ops],
                "idle_gaps": [[n[:64], s] for n, s in gaps]}


def record(unit, units: int) -> Trace:
    """Profile ``units`` calls of ``unit()`` (the first of which is not
    warm-up: the caller has warmed them), ending in a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        mark = torch.profiler.record_function(WINDOW)
        mark.__enter__()
        for _ in range(units):
            unit()
        if cuda:
            torch.cuda.synchronize()
        mark.__exit__(None, None, None)
        window_s = time.perf_counter() - t0
    device_ops, host_ops, start = [], [], None
    for e in prof.events():
        span = (e.name, e.time_range.start / 1e6, e.time_range.elapsed_us() / 1e6)
        if e.name == WINDOW:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                start = span[1]
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device_ops.append(span)
        elif e.cpu_parent is None or e.cpu_parent.name == WINDOW:
            host_ops.append(span)
    device_ops.sort(key=lambda op: op[1])
    if start is None:
        start = min((op[1] for op in device_ops + host_ops), default=0.0)
    return Trace(device_ops=device_ops, host_ops=host_ops, window_s=window_s, units=units,
                 start_s=start)
