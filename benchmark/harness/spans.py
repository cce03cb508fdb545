"""The port's own spans (``scal_sdt_tpu_torch/utils/tracing.py``) in a
``torch.profiler`` window of a few more units, and the device time each
holds.

``of(ctx)`` runs this spanned pass once per traced run, for the first
reader that asks, and keeps it on the work object: the port's tracing on,
``work.trace_units`` more units profiled with CPU and CUDA activity, the
tracing off again. ``trace.py``'s window, before it, runs with the tracing
off, so the readers of that window see no span and no span's device echo.
A program without the tracing module gives None, and so do the readers.

Each device operation is put down to the innermost span whose host
interval holds its launch: the runtime call (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...) that carries the operation's correlation id, on
the thread of the host operation the profiler links both to (a launch by
``ctypes`` inside a span has none: the runtime call's own thread). A span
on the launching thread comes first; where none holds the launch (autograd
runs the backward on threads of its own), the innermost span of another
thread that holds it. A span's parent is found the same way. The spans'
device echoes (``gpu_user_annotation``) are left out. A span's device time
is the busy time (the union of intervals) of the operations put down to it
or to a span under it.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

WINDOW = "benchmark_spans"   # the host's range around the spanned units


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    thread: int
    start: float                   # seconds on the profiler's clock
    end: float
    up: Span | None = None         # the span that holds it on its own thread
    parent: Span | None = None     # ``up``, else the innermost span of another thread

    def holds(self, t: float) -> bool:
        return self.start <= t <= self.end

    def chain(self):
        """The span and its parents, innermost first."""
        s = self
        while s is not None:
            yield s
            s = s.parent


@dataclasses.dataclass
class Op:
    """A device operation and the host call that launched it."""
    name: str
    start: float
    dur: float
    thread: int | None    # the launching thread (None: no launch found)
    launched: float       # when the launch began (without one, the operation's start)


def union_s(intervals) -> float:
    """Seconds covered by (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Spans:
    """The spans of the pass, its device operations each with the innermost
    span that launched it, the pass's host interval (``window``) and the
    thread that ran the units."""

    def __init__(self, spans: list[Span], ops: list[Op], window: tuple[float, float],
                 thread: int, units: int):
        self.window, self.thread, self.units = window, thread, units
        self.spans = sorted(spans, key=lambda s: (s.start, -s.end))
        self._threads: dict[int, tuple[list[Span], list[float]]] = {}
        for s in self.spans:
            on, starts = self._threads.setdefault(s.thread, ([], []))
            up = on[-1] if on else None
            while up is not None and not (up.holds(s.start) and s.end <= up.end):
                up = up.up
            s.up = up
            on.append(s)
            starts.append(s.start)
        for s in self.spans:
            s.parent = s.up or self._elsewhere(s.thread, s.start)
        self.ops = [(op, self.innermost(op.thread, op.launched)) for op in ops]

    def _on(self, thread: int, t: float) -> Span | None:
        """The innermost span of ``thread`` that holds ``t``: the last one
        opened before ``t`` or one of those that hold it (spans of one
        thread nest)."""
        on, starts = self._threads.get(thread, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        s = on[i] if i >= 0 else None
        while s is not None and not s.holds(t):
            s = s.up
        return s

    def _elsewhere(self, thread: int | None, t: float) -> Span | None:
        found = [self._on(th, t) for th in self._threads if th != thread]
        return max((s for s in found if s is not None), key=lambda s: s.start, default=None)

    def innermost(self, thread: int | None, t: float) -> Span | None:
        """The span that holds a launch on ``thread`` at ``t``."""
        return (self._on(thread, t) if thread is not None else None) or \
            self._elsewhere(thread, t)

    def _named(self, name: str, under: str | None) -> set:
        """The spans under a span ``name`` (itself included) that is itself
        under a span ``under``."""
        out = set()
        for s in self.spans:
            chain = list(s.chain())
            for i, c in enumerate(chain):
                if c.name == name:
                    if under is None or any(p.name == under for p in chain[i + 1:]):
                        out.add(s)
                    break
        return out

    def count(self, name: str, under: str | None = None) -> int:
        """Spans ``name`` (under a span ``under``)."""
        return sum(s.name == name and (under is None or any(
            p.name == under for p in list(s.chain())[1:])) for s in self.spans)

    def device_s(self, name: str | None = None, under: str | None = None) -> float:
        """The busy seconds of the device operations put down to a span
        ``name`` (under a span ``under``) or to a span under it; with no
        ``name``, of every device operation of the pass."""
        if name is None:
            return union_s((op.start, op.start + op.dur) for op, _ in self.ops)
        held = self._named(name, under)
        return union_s((op.start, op.start + op.dur) for op, s in self.ops if s in held)

    def idle_s(self, name: str) -> tuple[float, float]:
        """(idle seconds of the window whose gap's midpoint falls while the
        units' thread is inside a span ``name``, all idle seconds of the
        window)."""
        a, b = self.window
        busy: list[list[float]] = []
        for op, _ in sorted(self.ops, key=lambda x: x[0].start):
            s, e = max(op.start, a), min(op.start + op.dur, b)
            if e <= s:
                continue
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        edges = [a] + [x for iv in busy for x in iv] + [b]
        inside = total = 0.0
        for lo, hi in zip(edges[0::2], edges[1::2]):
            if hi <= lo:
                continue
            total += hi - lo
            s = self._on(self.thread, (lo + hi) / 2)
            if s is not None and any(c.name == name for c in s.chain()):
                inside += hi - lo
        return inside, total

    def table(self) -> dict[str, tuple[int, float]]:
        """Each span name: (spans, device seconds), over the whole pass."""
        return {n: (self.count(n), self.device_s(n))
                for n in sorted({s.name for s in self.spans})}


def collect(prof, units: int, window: str = WINDOW) -> Spans:
    """The spans of a finished ``torch.profiler`` run whose units ran inside
    a range ``window``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)

    def sec(ns: int) -> float:
        return (ns - base) / 1e9

    ops_by_id, runtime, marks, device = {}, {}, [], []
    for e in events:
        if e.device_type() != DeviceType.CPU:
            if not e.is_user_annotation():
                device.append(e)
        elif e.name().startswith("cu") and "::" not in e.name():
            runtime[e.correlation_id()] = e   # cudaLaunchKernel, cudaMemcpyAsync, ...
        else:
            ops_by_id[e.correlation_id()] = e
            if e.is_user_annotation():
                marks.append(e)
    ranges = [Span(e.name(), e.start_thread_id(), sec(e.start_ns()),
                   sec(e.start_ns() + e.duration_ns())) for e in marks]
    names = {s.name for s in ranges}
    frame = next(s for s in ranges if s.name == window)
    ops = []
    for e in device:
        if e.name() in names:
            continue
        call = runtime.get(e.correlation_id())
        linked = ops_by_id.get(e.linked_correlation_id()) if e.linked_correlation_id() else None
        thread = next((x.start_thread_id() for x in (linked, call) if x is not None), None)
        at = next((x.start_ns() for x in (call, linked) if x is not None), e.start_ns())
        ops.append(Op(e.name(), sec(e.start_ns()), e.duration_ns() / 1e9, thread, sec(at)))
    return Spans([s for s in ranges if s is not frame], ops, (frame.start, frame.end),
                 frame.thread, units)


def record(unit, units: int) -> Spans | None:
    """``units`` calls of ``unit()`` (warm) with the port's tracing on,
    profiled, ending in a synchronize; None where the program has no
    tracing module."""
    try:
        from scal_sdt_tpu_torch.utils import tracing
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof, tracing.on():
        with torch.profiler.record_function(WINDOW):
            for _ in range(units):
                unit()
            if cuda:
                torch.cuda.synchronize()
    return collect(prof, units)


def of(ctx) -> Spans | None:
    """The traced run's spanned pass, made at the first call; None where
    the program has no spans or the pass saw no device operation."""
    work = ctx.work
    if not hasattr(work, "spans"):
        work.spans = record(work.unit, work.trace_units)
    s = work.spans
    return s if s is not None and s.ops else None


def per_unit_ms(ctx, name: str, under: str | None = None) -> float | None:
    """Device ms a unit of the spans ``name`` (under ``under``); None
    without a pass or without the span that holds them."""
    s = of(ctx)
    if s is None or not s.count(under or name):
        return None
    return 1e3 * s.device_s(name, under) / s.units
