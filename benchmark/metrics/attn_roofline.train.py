"""attn_roofline.train: the splash attention kernels' share of their
roofline in the traced training steps, in %.

The work is that of every self-attention the splash gate takes (Lq and Lk of
1,024 or more) at the configuration's shapes, whatever runs it: per call of
(B, H, Lq, Lk, D), the forward's two products (4 B H Lq Lk D FLOPs) and
B H Lq Lk exponentials, reading q, k, v and writing o and the log-sum-exp;
the backward's five products (10 B H Lq Lk D: the scores once more, dP, dV,
dQ, dK) and the exponentials once more, reading q, k, v, o, dO and the
log-sum-exp and writing dq, dk, dv; bf16 tensors, fp32 log-sum-exp, each
byte once. Each pass's bound is the largest of its FLOPs over the bf16 peak,
its bytes over the HBM bandwidth and its exponentials over the unit's rate.
The share is the bounds' sum over the device time of the kernels named
``splash_``.
"""

PATTERNS = ("splash_",)
GATE = 1024


def bound_s(b, h, lq, lk, d, peaks):
    exps = b * h * lq * lk
    fwd_bytes = 2 * b * h * d * (2 * lq + 2 * lk) + 4 * b * h * lq
    bwd_bytes = 2 * b * h * d * (3 * lq + 2 * lk) + 4 * b * h * lq + 2 * b * h * d * (lq + 2 * lk)

    def one(flops, nbytes):
        return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"],
                   exps / peaks["exp_per_s"])

    return one(4 * exps * d, fwd_bytes) + one(10 * exps * d, bwd_bytes)


def read(ctx):
    kernels = ctx.trace.kernels(*PATTERNS)
    if ctx.peaks is None or not kernels:
        return None
    t = ctx.cell.traffic
    calls = ctx.family.attention_calls(ctx.cell.config, t["resolution"], t["context"])
    per_step = sum(bound_s(t["batch"], h, lq, lk, d, ctx.peaks)
                   for h, lq, lk, d in calls if lq >= GATE and lk >= GATE)
    return 100.0 * per_step * ctx.trace.units / sum(k[2] for k in kernels)
