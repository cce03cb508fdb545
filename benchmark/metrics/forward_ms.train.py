"""forward_ms.train: the device time of the port's ``train.forward`` span
(``training/step.py`` ``loss_and_grads``: the ``compute_loss`` call) a
training step, in ms, from the spanned pass (``harness/spans.py``)."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "train.forward")
