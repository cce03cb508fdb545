"""mfu.train: the training window's model FLOPs over the card's dense bf16
peak, in %. A train step counts 3 x the forward's matmul and convolution
FLOPs (the backward about twice the forward; no recompute counted), the
forward from the configuration's shapes (``families/<family>.py``
``forward_flops``)."""


def read(ctx):
    if ctx.peaks is None:
        return None
    t = ctx.cell.traffic
    per_image = 3.0 * ctx.family.forward_flops(ctx.cell.config, t["resolution"], t["context"])
    return 100.0 * per_image * ctx.window["images"] / ctx.window["seconds"] \
        / ctx.peaks["bf16_flops"]
