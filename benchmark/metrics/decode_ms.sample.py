"""decode_ms.sample: the device time of the port's ``sample.decode`` span
(``diffusion/sampler.py``: the VAE decoder to the uint8 array) per sampled
image, in ms, from the spanned pass (``harness/spans.py``)."""

from benchmark.harness import spans


def read(ctx):
    s = spans.of(ctx)
    if s is None or not s.count("sample.decode"):
        return None
    return 1e3 * s.device_s("sample.decode") / (s.units * ctx.work.images_per_unit)
