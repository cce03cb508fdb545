"""idle_in_step.train: of the spanned pass's device-idle time
(``harness/spans.py``), the share whose gap's midpoint falls while the
thread that runs the steps is inside the port's ``train.step`` span, in %.
The rest is idle time between steps, in the harness."""

from benchmark.harness import spans


def read(ctx):
    s = spans.of(ctx)
    if s is None or not s.count("train.step"):
        return None
    inside, total = s.idle_s("train.step")
    return 100.0 * inside / total if total > 0 else 0.0
