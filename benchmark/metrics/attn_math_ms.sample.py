"""attn_math_ms.sample: the device time of the port's ``attention.math``
spans (``ops/attention.py`` ``_dispatch``: the calls below the splash gate)
under ``sample.denoise`` per denoiser call, in ms, from the spanned pass
(``harness/spans.py``). CLIP's causal attention under ``sample.text`` and
the VAE's under ``sample.decode`` stay under their own spans."""

from benchmark.harness import spans


def read(ctx):
    s = spans.of(ctx)
    calls = s.count("sample.denoise") if s is not None else 0
    return 1e3 * s.device_s("attention.math", under="sample.denoise") / calls if calls else None
