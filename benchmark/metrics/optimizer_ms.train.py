"""optimizer_ms.train: the device time of the port's ``train.optimizer``
span (``training/step.py``: ``tx.update_and_apply``, whole: the fused
launch and every other device operation of the update) a training step, in
ms, from the spanned pass (``harness/spans.py``)."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "train.optimizer")
