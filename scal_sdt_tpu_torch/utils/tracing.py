"""Named spans in the port's hot path, as ``torch.profiler`` ranges.

``span(name)`` opens ``torch.profiler.record_function(name)`` while tracing
is on, so the span lands in the active profiler's trace, on its clock,
nested under the span or operation that holds it; the profiler keeps it in
memory with the rest of its trace and writes it out with it. While tracing
is off (everywhere but inside ``on()``), ``span`` returns one shared no-op
context after one flag check: no allocation and no profiler call.

``on()`` turns tracing on for its scope (every thread of the process, so
autograd's own threads trace too); ``enabled()`` says whether it is on. The
trainer's ``profiler:`` window and the benchmark's spanned pass turn it on.

The spans (``PERF.md`` §3 lists what reads each):

* ``train.step`` (``training/step.py`` ``make_train_step``'s step, whole),
  holding ``train.cast`` (the compute-dtype copies of the masters),
  ``train.forward`` (``compute_loss``), ``train.backward``
  (``torch.autograd.grad``), ``train.allreduce`` (the gradients' and the
  loss's mean over the data-parallel ranks), ``train.optimizer``
  (``tx.update_and_apply``), ``train.ema`` and ``train.refresh`` (the
  sharded masters' compute copies);
* ``attention.splash`` and ``attention.math`` (``ops/attention.py``
  ``_dispatch``, one per call, by the path taken);
* ``sample.text`` (the prompt and negative-prompt encodes),
  ``sample.denoise`` (one per UNet or MMDiT call) and ``sample.decode``
  (the VAE decoder to the uint8 array) in ``diffusion/sampler.py``;
* ``trainer.batch``, ``trainer.log``, ``trainer.save`` and
  ``trainer.sample`` in ``training/trainer.py``'s loop.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_on = False


class _NoSpan:
    """The span while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


def span(name: str):
    """A context that records ``name`` as a profiler range while tracing is
    on, and does nothing otherwise."""
    if not _on:
        return NO_SPAN
    return torch.profiler.record_function(name)


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def on() -> Iterator[None]:
    """Tracing on for the scope, then as it was before."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before
