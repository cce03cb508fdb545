"""The port's spans (``scal_sdt_tpu_torch/utils/tracing.py``) and the
benchmark's reading of them (``benchmark/harness/spans.py``).

On the CPU, through the benchmark's tiny cells (``benchmark/tests/tiny.py``:
the port's own step and sampler at tiny widths): with the tracing off no
span reaches the profiler; with it on, a UNet step and an MMDiT step give
``train.step`` holding the cast, forward, backward and optimizer, and one
attention span per call, by the path the gate takes; a sample gives one
``sample.text``, a ``sample.denoise`` per step and one ``sample.decode``.
The helper's attribution and union are checked on synthetic spans and
operations, one of them launched from a second thread during
``train.backward``; each reader gives no reading, and runs no pass, for a
program without the tracing module. On a card (``cuda``-marked, skipped elsewhere): the
existing trace window is unchanged with the tracing off, and the
backward's kernels land under ``train.backward``. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import contextlib
import json
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import spans as S
from benchmark.harness import spec as spec_mod
from benchmark.harness import trace as T
from benchmark.harness.runner import make_work
from benchmark.tests import tiny
from scal_sdt_tpu_torch.ops import attention
from scal_sdt_tpu_torch.utils import tracing

STEP_PHASES = ("train.cast", "train.forward", "train.backward", "train.optimizer")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _work(root, cell, device="cpu", **traffic):
    c = spec_mod.resolve(cell, root)
    c.traffic.update(traffic)
    work, _ = make_work(c, 2 ** 31 + 11, device)
    work.setup()
    return work


def test_span_is_the_shared_no_op_while_off():
    assert not tracing.enabled()
    assert tracing.span("train.step") is tracing.NO_SPAN
    with tracing.on():
        assert tracing.enabled()
        assert isinstance(tracing.span("train.step"), torch.profiler.record_function)
        with tracing.on():
            pass
        assert tracing.enabled()
    assert not tracing.enabled() and tracing.span("x") is tracing.NO_SPAN


@pytest.mark.parametrize("cell,traffic", [("tiny-unet-train", {}),
                                          ("tiny-unet-sample", {"steps": 2})])
def test_tracing_off_makes_no_profiler_call(root, cell, traffic, monkeypatch):
    work = _work(root, cell, **traffic)

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened with the tracing off")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    work.unit()
    with pytest.raises(AssertionError, match="tracing off"), tracing.on():
        work.unit()


def _parent(s):
    return s.parent.name if s.parent is not None else None


@pytest.mark.parametrize("cell", ["tiny-unet-train", "tiny-mmdit-train"])
def test_step_spans_nest_and_attention_spans_follow_the_gate(root, cell, monkeypatch):
    """Every other attention call is sent down the splash branch (its
    kernel stood in by the math path, which the CPU runs): each call gives
    the span of the branch it took, under ``train.forward``."""
    work = _work(root, cell)
    taken = []

    def gate(q_shape, k_shape, dtype, causal, is_cuda):
        taken.append(len(taken) % 2 == 0 and not causal)
        return taken[-1]

    monkeypatch.setattr(attention, "use_kernel", gate)
    monkeypatch.setattr(attention, "splash_attention",
                        lambda q, k, v, scale: attention._attention_math(q, k, v, scale))
    s = S.record(work.unit, 2)
    assert s.count("train.step") == 2
    for name in STEP_PHASES:
        assert s.count(name) == 2 and s.count(name, under="train.step") == 2
        assert {_parent(x) for x in s.spans if x.name == name} == {"train.step"}
    splash, math = sum(taken), len(taken) - sum(taken)
    assert splash > 0 and math > 0
    assert s.count("attention.splash", under="train.forward") == splash
    assert s.count("attention.math", under="train.forward") == math
    assert s.count("attention.splash") + s.count("attention.math") == len(taken)
    assert {x.name for x in s.spans} == {"train.step", *STEP_PHASES, "attention.splash",
                                         "attention.math"}


def test_sample_spans(root):
    steps = 3
    work = _work(root, "tiny-unet-sample", steps=steps)
    s = S.record(work.unit, 1)
    assert (s.count("sample.text"), s.count("sample.denoise"), s.count("sample.decode")) \
        == (1, steps, 1)
    assert {_parent(x) for x in s.spans if x.name.startswith("sample.")} == {None}
    # CLIP's causal attention and the VAE's stay under their own spans
    calls = s.count("attention.math")
    assert s.count("attention.math", under="sample.text") > 0
    assert s.count("attention.math", under="sample.decode") > 0
    assert s.count("attention.math", under="sample.denoise") % steps == 0
    assert calls == sum(s.count("attention.math", under=p)
                        for p in ("sample.text", "sample.denoise", "sample.decode"))


def test_trainer_profile_carries_the_spans(tmp_path):
    """The trainer's ``profiler:`` window turns the tracing on for its
    steps, and off after them."""
    from scal_sdt_tpu_torch.training.trainer import _StepProfiler

    prof = _StepProfiler({"enabled": True, "start_step": 1, "num_steps": 1, "dir": str(tmp_path)},
                         tmp_path, torch.device("cpu"))
    for step in range(3):
        prof.before_step(step)
        assert tracing.enabled() is (step == 1)
        with tracing.span("train.step"):
            torch.ones(4).sum()
        prof.after_step(step + 1)
    prof.close()
    assert not tracing.enabled()
    names = [e.get("name") for e in json.loads((tmp_path / "trace_step1.json").read_text())
             ["traceEvents"]]
    assert names.count("train.step") == 1


SPAN_READERS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
                "attn_math_fwd_ms.train", "idle_in_step.train", "denoise_ms.sample",
                "decode_ms.sample", "attn_math_ms.sample")


@pytest.mark.parametrize("metric", SPAN_READERS)
def test_reader_gives_none_for_a_program_without_spans(metric, monkeypatch):
    """A program without the tracing module (the port before it had one)
    gives no reading and no error: the spanned pass is not run."""
    import scal_sdt_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.delitem(sys.modules, "scal_sdt_tpu_torch.utils.tracing")
    monkeypatch.setattr(utils, "__path__", [])   # as if the file were not there
    calls = []
    work = SimpleNamespace(unit=lambda: calls.append(1), trace_units=2, images_per_unit=4)
    reader = spec_mod.load_module(spec_mod.ROOT / "benchmark" / "metrics" / f"{metric}.py")
    assert reader.read(SimpleNamespace(work=work)) is None
    assert calls == [] and work.spans is None


def _synthetic():
    """Thread 1 runs a step; thread 2 (autograd's) launches the backward's
    operations, one of them inside a recomputed attention call."""
    step = S.Span("train.step", 1, 0.0, 10.0)
    fwd = S.Span("train.forward", 1, 1.0, 4.0)
    attn = S.Span("attention.math", 1, 2.0, 3.0)
    bwd = S.Span("train.backward", 1, 5.0, 8.0)
    again = S.Span("attention.math", 2, 6.0, 6.5)
    opt = S.Span("train.optimizer", 1, 8.5, 9.5)
    ops = [S.Op("a", 2.6, 0.5, 1, 2.5),      # attention.math
           S.Op("b", 2.0, 1.0, 1, 1.5),      # train.forward, overlaps a
           S.Op("c", 5.6, 0.2, 2, 5.5),      # autograd's thread: train.backward
           S.Op("d", 6.3, 0.4, 2, 6.2),      # the recomputed attention.math
           S.Op("e", 7.1, 0.3, None, 7.0),   # not linked: held by time alone
           S.Op("f", 9.0, 0.5, 1, 8.9),      # train.optimizer
           S.Op("g", 10.6, 0.3, 1, 10.5)]    # between steps
    return S.Spans([opt, again, bwd, attn, fwd, step], ops, (0.0, 12.0), 1, 1), ops


def test_attribution_and_union_on_synthetic_events():
    s, ops = _synthetic()
    held = {op.name: (span.name if span else None, _parent(span) if span else None)
            for op, span in s.ops}
    assert held == {"a": ("attention.math", "train.forward"),
                    "b": ("train.forward", "train.step"),
                    "c": ("train.backward", "train.step"),
                    "d": ("attention.math", "train.backward"),
                    "e": ("train.backward", "train.step"),
                    "f": ("train.optimizer", "train.step"), "g": (None, None)}
    assert s.device_s("train.forward") == pytest.approx(1.1)          # b, and a past it
    assert s.device_s("attention.math", under="train.forward") == pytest.approx(0.5)
    assert s.device_s("attention.math", under="train.backward") == pytest.approx(0.4)
    assert s.device_s("train.backward") == pytest.approx(0.9)
    assert s.device_s("train.step") == pytest.approx(2.5)
    assert s.device_s() == pytest.approx(2.8)
    assert s.count("attention.math") == 2
    assert s.count("attention.math", under="train.backward") == 1
    inside, total = s.idle_s("train.step")
    assert total == pytest.approx(12.0 - 2.8)
    assert inside == pytest.approx(total - 1.1 - 1.1)   # [9.5, 10.6), [10.9, 12): between steps
    assert S.union_s([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == pytest.approx(3.0)
    assert S.union_s([]) == 0.0


class _Event:
    """A profiler event as ``collect`` reads it (times in ns)."""

    def __init__(self, name, device, corr, linked, thread, start, dur, annotation=False):
        self._v = (name, device, corr, linked, thread, start, dur, annotation)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def correlation_id(self): return self._v[2]
    def linked_correlation_id(self): return self._v[3]
    def start_thread_id(self): return self._v[4]
    def start_ns(self): return self._v[5]
    def duration_ns(self): return self._v[6]
    def is_user_annotation(self): return self._v[7]


def test_collect_links_each_launch_to_its_span():
    """A kernel launched by an operation inside ``train.forward``; one that
    autograd's thread launches during ``train.backward``; one launched by
    ``ctypes`` straight inside ``train.optimizer`` (no operation links it:
    its runtime call does, and the runtime's correlation ids may equal an
    operation's); the spans' device echoes left out."""
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ms = 1_000_000
    events = [
        _Event(S.WINDOW, cpu, 1, 0, 1, 0, 100 * ms, True),
        _Event("train.step", cpu, 2, 0, 1, 1 * ms, 90 * ms, True),
        _Event("train.forward", cpu, 3, 0, 1, 2 * ms, 20 * ms, True),
        _Event("aten::mm", cpu, 4, 0, 1, 5 * ms, 2 * ms),
        _Event("cudaLaunchKernel", cpu, 500, 4, 1, 6 * ms, ms // 10),
        _Event("gemm", gpu, 500, 4, 7, 30 * ms, 4 * ms),
        _Event("train.backward", cpu, 5, 0, 1, 25 * ms, 40 * ms, True),
        _Event("autograd::engine::evaluate_function: MmBackward0", cpu, 6, 0, 2, 30 * ms,
               5 * ms),
        _Event("cudaLaunchKernel", cpu, 501, 6, 2, 31 * ms, ms // 10),
        _Event("gemm_bwd", gpu, 501, 6, 7, 40 * ms, 10 * ms),
        _Event("train.optimizer", cpu, 7, 0, 1, 70 * ms, 10 * ms, True),
        _Event("aten::zero_", cpu, 502, 0, 1, 99 * ms, ms // 10),   # an id like a launch's
        _Event("cudaLaunchKernel", cpu, 502, 0, 1, 72 * ms, ms // 10),
        _Event("adam", gpu, 502, 0, 7, 85 * ms, 3 * ms),
        _Event("train.forward", gpu, 3, 0, 7, 30 * ms, 4 * ms, True),   # an echo
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    s = S.collect(prof, 1)
    assert s.window == (0.0, 0.1) and s.thread == 1
    held = {op.name: (op.thread, span.name) for op, span in s.ops}
    assert held == {"gemm": (1, "train.forward"), "gemm_bwd": (2, "train.backward"),
                    "adam": (1, "train.optimizer")}
    assert s.device_s("train.step") == pytest.approx(0.017)
    assert s.device_s("train.forward") == pytest.approx(0.004)


# --- on a card ----------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield "cuda"
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_trace_window_is_unchanged_with_tracing_off(root, cuda, monkeypatch):
    """``trace.record`` counts the same kernels and about the same busy time
    as with no span in the program, and no span's device echo; with the
    tracing on, the echoes would count as kernels."""
    work = _work(root, "tiny-unet-train", cuda)
    work.unit()
    off = T.record(work.unit, 3)
    with tracing.on():
        on = T.record(work.unit, 3)
    monkeypatch.setattr(tracing, "span", lambda name: contextlib.nullcontext())
    parent = T.record(work.unit, 3)
    names = {op[0] for op in off.device_ops}
    assert not names & {"train.step", *STEP_PHASES, "attention.math", "attention.splash"}
    assert len(off.kernels()) == len(parent.kernels()) < len(on.kernels())
    assert off.busy_s == pytest.approx(parent.busy_s, rel=0.25)


@pytest.mark.cuda
def test_backward_kernels_land_under_train_backward(root, cuda):
    work = _work(root, "tiny-unet-train", cuda)
    work.unit()
    s = S.record(work.unit, 2)
    under = [(op, span) for op, span in s.ops
             if span is not None and "train.backward" in {c.name for c in span.chain()}]
    assert under and s.device_s("train.backward") > 0
    assert any(op.thread != s.thread for op, _ in under), "no launch from autograd's thread"
    assert sum(s.device_s(n) for n in STEP_PHASES) >= 0.95 * s.device_s("train.step")
