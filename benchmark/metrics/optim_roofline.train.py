"""optim_roofline.train: the optimizer kernel's share of its roofline in the
traced training steps, in %.

The work of one AdamW step over the trainable leaves: the masters and both
moments each read once and written once, the bf16 gradients read once, in
the dtypes the traffic mix states (fp32 moments where it states none), over
the HBM bandwidth. The time is that of the kernels named ``adam``.
"""

import math

PATTERNS = ("adam",)
BYTES = {"fp32": 4, "bf16": 2, None: 4}
GRAD_BYTES = 2


def read(ctx):
    kernels = ctx.trace.kernels(*PATTERNS)
    if ctx.peaks is None or not kernels:
        return None
    o = ctx.cell.traffic["optimizer"]
    frozen = set(getattr(ctx.family, "FROZEN", ()))
    n = sum(math.prod(s) for k, s in ctx.family.shapes(ctx.cell.config).items()
            if k not in frozen)
    per_elem = 2 * BYTES[o["master_dtype"]] + 4 * BYTES[o["moment_dtype"]] + GRAD_BYTES
    bound = n * per_elem / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * bound * ctx.trace.units / sum(k[2] for k in kernels)
