"""backward_ms.train: the device time of the port's ``train.backward`` span
(``training/step.py`` ``loss_and_grads``: ``torch.autograd.grad``) a
training step, in ms, from the spanned pass (``harness/spans.py``). The
backward's kernels are launched from autograd's own thread; each is put
down to the span by the host operation that launched it."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "train.backward")
