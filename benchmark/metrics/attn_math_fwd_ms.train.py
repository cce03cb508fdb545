"""attn_math_fwd_ms.train: the device time of the port's ``attention.math``
spans (``ops/attention.py`` ``_dispatch``: the calls below the splash gate)
under ``train.forward``, a training step, in ms, from the spanned pass
(``harness/spans.py``). Their backward runs under ``train.backward`` and is
not split out. 0 where every call takes the splash kernels."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "attention.math", under="train.forward")
