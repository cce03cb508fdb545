"""denoise_ms.sample: the device time of the port's ``sample.denoise``
spans (``diffusion/sampler.py``: one per UNet call on the CFG pair, the
pair's combination included) per denoiser call, in ms, from the spanned
pass (``harness/spans.py``)."""

from benchmark.harness import spans


def read(ctx):
    s = spans.of(ctx)
    calls = s.count("sample.denoise") if s is not None else 0
    return 1e3 * s.device_s("sample.denoise") / calls if calls else None
