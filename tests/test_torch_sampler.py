"""The port's samplers (DDIM, Euler, Euler-a, DPM++(2M)) and the whole
sampling path against the JAX package, on the CPU.

The JAX loops run eagerly through ``__wrapped__`` (as
``tests/test_euler_samplers.py`` runs them), with JAX's draws carried into
the port through ``SamplerDraws``. Each method runs first with a stub
denoiser monkeypatched into both modules' ``unet_apply`` (the ladder, the
CFG combine, the guidance rescale and the update rules alone), then with
the tiny real UNet for 3 steps. Cases: epsilon and v prediction, a trailing
zero-terminal-SNR schedule, guidance rescale 0 and 0.7, img2img at strength
0.75, fp32 and bf16 ``spec.dtype``.

Tolerances (max-abs error over the reference's largest entry): fp32 1e-5
(the stub, where only the update rules' rounding differs) and 1e-4 (the
real UNet, whose sums run in another order); bf16 with the stub 2^-6, two
bf16 ulps of the largest entry, since each package rounds its bf16 chain
at other points (XLA on the CPU keeps fused bf16 chains in fp32) and DDIM
carries x in bf16. The bf16 UNet itself differs between the packages by
about 1.6% of its largest output in one call (as much as JAX's bf16 UNet
differs from its fp32 one), and CFG scales that difference, so with the
real UNet in bf16 the port is held to 2^-3 of JAX's result (3.3-5.8%
measured) and to at most 1.25 times JAX's own distance from the fp32
result. ``sample_images`` (CLIP, sampler, VAE decoder, uint8) in fp32:
within one uint8 level.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scal_sdt_tpu.diffusion.sampler as jsampler
import scal_sdt_tpu_torch.diffusion.sampler as tsampler
from scal_sdt_tpu.diffusion.schedule import NoiseSchedule as JSchedule
from scal_sdt_tpu.models import clip as jclip
from scal_sdt_tpu.models import unet as junet
from scal_sdt_tpu.models import vae as jvae
from scal_sdt_tpu_torch.convert.from_jax import params_from_jax
from scal_sdt_tpu_torch.diffusion.schedule import NoiseSchedule as TSchedule
from scal_sdt_tpu_torch.models import clip as tclip
from scal_sdt_tpu_torch.models import mmdit as tmmdit
from scal_sdt_tpu_torch.models import unet as tunet
from scal_sdt_tpu_torch.models import vae as tvae

from torch_port_helpers import nchw, rand_unet_params, to_np, to_torch

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
UNET_TOL = 1e-4
BF16_UNET_TOL = 2.0 ** -3
BF16_DRIFT = 1.25
H = W = 32          # image size; the tiny VAE's 2 levels make 16x16 latents
BATCH = 2
CFG = 5.0
PROMPTS = ["a photo of a cat", "sks dog on the beach"]
NEGATIVE = "blurry lowres"
JAX_METHODS = {"ddim": (jsampler.ddim_sample_latents, {}),
               "euler": (jsampler.euler_sample_latents, {"ancestral": False}),
               "euler_a": (jsampler.euler_sample_latents, {"ancestral": True}),
               "dpmpp_2m": (jsampler.dpmpp_2m_sample_latents, {})}
TORCH_METHODS = {"ddim": (tsampler.ddim_sample_latents, {}),
                 "euler": (tsampler.euler_sample_latents, {"ancestral": False}),
                 "euler_a": (tsampler.euler_sample_latents, {"ancestral": True}),
                 "dpmpp_2m": (tsampler.dpmpp_2m_sample_latents, {})}
SCHEDULES = {"eps": {}, "v": {"prediction_type": "v"},
             "v-ztsnr-trailing": {"prediction_type": "v", "rescale_zero_terminal_snr": True,
                                  "timestep_spacing": "trailing"}}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _err(got, want) -> float:
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _specs(schedule: str, dtype: str):
    jdt, tdt = DTYPES[dtype]
    kw = SCHEDULES[schedule]
    jclip_cfg = jclip.CLIPTextConfig.tiny()
    tclip_cfg = tclip.CLIPTextConfig.tiny()
    js = jsampler.SamplerSpec(unet_config=junet.UNetConfig.tiny(),
                              vae_config=jvae.VAEConfig.tiny(), clip_config=jclip_cfg,
                              schedule=JSchedule(**kw), dtype=jdt)
    ts = tsampler.SamplerSpec(unet_config=tunet.UNetConfig.tiny(),
                              vae_config=tvae.VAEConfig.tiny(), clip_config=tclip_cfg,
                              schedule=TSchedule(**kw), dtype=tdt)
    return js, ts


def jax_draws(method: str, rng, spec, steps: int, shape_nhwc) -> tsampler.SamplerDraws:
    """The draws JAX's loop ``method`` makes from ``rng`` (the key it is
    handed), NCHW for the port."""
    if method == "ddim":
        return tsampler.SamplerDraws(noise=nchw(jax.random.normal(rng, shape_nhwc, spec.dtype)))
    rng, init_rng = jax.random.split(rng)
    draws = tsampler.SamplerDraws(noise=nchw(jax.random.normal(init_rng, shape_nhwc,
                                                               jnp.float32)))
    if method == "euler_a":
        step_noise = []
        for _ in range(steps):
            rng, k = jax.random.split(rng)
            step_noise.append(nchw(jax.random.normal(k, shape_nhwc, jnp.float32)))
        draws.step_noise = step_noise
    return draws


def _conds(dtype: str, seed: int = 0):
    rs = np.random.RandomState(seed)
    cond = rs.randn(BATCH, 77, 32).astype(np.float32)
    uncond = rs.randn(BATCH, 77, 32).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(cond, jdt), jnp.asarray(uncond, jdt)),
            (torch.from_numpy(cond).to(tdt), torch.from_numpy(uncond).to(tdt)))


def _init_latents(dtype: str):
    x = np.random.RandomState(7).randn(BATCH, H // 2, W // 2, 4).astype(np.float32) * 0.5
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), nchw(x).to(tdt)


def _jax_stub(p, x, t, c, cfg, **kw):
    """A closed-form denoiser, NHWC: the same function as _torch_stub."""
    xf = x.astype(jnp.float32)
    out = (0.5 * xf + 0.1 * jnp.mean(c.astype(jnp.float32), axis=(1, 2))[:, None, None, None]
           + (t.astype(jnp.float32) / 1000.0)[:, None, None, None] * jnp.sin(xf))
    return out.astype(x.dtype)


def _torch_stub(p, x, t, c, cfg, **kw):
    xf = x.float()
    out = (0.5 * xf + 0.1 * c.float().mean(dim=(1, 2))[:, None, None, None]
           + (t.float() / 1000.0)[:, None, None, None] * torch.sin(xf))
    return out.to(x.dtype)


def _run_pair(method, schedule, dtype, steps, rescale, img2img, jparams, tparams, seed=0):
    js, ts = _specs(schedule, dtype)
    (jc, ju), (tc, tu) = _conds(dtype, seed)
    rng = jax.random.PRNGKey(seed)
    t_start = int(steps * (1 - 0.75)) if img2img else 0
    n_run = steps - t_start
    shape = (BATCH, H // 2, W // 2, 4)
    draws = jax_draws(method, rng, js, n_run, shape)
    jinit, tinit = _init_latents(dtype) if img2img else (None, None)
    jfn, jkw = JAX_METHODS[method]
    want = jfn.__wrapped__(jparams, jc, ju, rng, js, steps, CFG, H, W, BATCH,
                           init_latents=jinit, t_start_index=t_start,
                           guidance_rescale=rescale, **jkw)
    tfn, tkw = TORCH_METHODS[method]
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        got = tfn(tparams, tc, tu, gen, ts, steps, CFG, H, W, BATCH, init_latents=tinit,
                  t_start_index=t_start, guidance_rescale=rescale, draws=draws, **tkw)
    assert got.dtype == DTYPES[dtype][1]
    return got, np.asarray(want).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("steps", [1, 7, 28, 50])
def test_ddim_timesteps_match_jax(spacing, steps):
    kw = {"timestep_spacing": spacing, "steps_offset": 1}
    np.testing.assert_array_equal(tsampler.ddim_timesteps(TSchedule(**kw), steps),
                                  jsampler.ddim_timesteps(JSchedule(**kw), steps))


@pytest.mark.parametrize("case", [
    ("ddim", "eps", "float32", 0.0, False), ("ddim", "v", "bfloat16", 0.7, False),
    ("ddim", "v-ztsnr-trailing", "float32", 0.7, True), ("ddim", "eps", "bfloat16", 0.0, True),
    ("euler", "eps", "float32", 0.7, False), ("euler", "v-ztsnr-trailing", "bfloat16", 0.0, False),
    ("euler", "v", "float32", 0.0, True),
    ("euler_a", "eps", "bfloat16", 0.7, True), ("euler_a", "v-ztsnr-trailing", "float32", 0.7,
                                                 False),
    ("dpmpp_2m", "eps", "float32", 0.0, False), ("dpmpp_2m", "v", "bfloat16", 0.7, False),
    ("dpmpp_2m", "v-ztsnr-trailing", "float32", 0.0, True),
], ids=lambda c: "-".join(map(str, c)))
def test_sampler_with_a_stub_denoiser_matches_jax(case, monkeypatch):
    method, schedule, dtype, rescale, img2img = case
    monkeypatch.setattr(jsampler, "unet_apply", _jax_stub)
    monkeypatch.setattr(tsampler, "unet_apply", _torch_stub)
    got, want = _run_pair(method, schedule, dtype, 8, rescale, img2img, {}, {})
    assert np.isfinite(to_np(got)).all()
    err = _err(got, want)
    assert err <= TOL[dtype], f"{case}: {err}"


@pytest.fixture(scope="module")
def tiny_unet():
    shapes = junet.unet_param_shapes(junet.UNetConfig.tiny())
    return rand_unet_params(shapes, seed=3)


@pytest.mark.parametrize("method", ["ddim", "euler", "euler_a", "dpmpp_2m"])
def test_sampler_with_the_tiny_unet_matches_jax(method, tiny_unet):
    """3 steps with the tiny UNet in fp32 (within UNET_TOL of JAX) and in
    bf16: there the port stays within BF16_UNET_TOL of JAX, and no further
    from the fp32 result than BF16_DRIFT times JAX's own bf16 result is."""
    schedule, rescale, img2img = {"ddim": ("v", 0.7, False), "euler": ("v", 0.0, True),
                                  "euler_a": ("eps", 0.0, False),
                                  "dpmpp_2m": ("v-ztsnr-trailing", 0.7, False)}[method]
    out = {}
    for dtype in DTYPES:
        jdt, tdt = DTYPES[dtype]
        jparams = {k: jnp.asarray(v, jdt) for k, v in tiny_unet.items()}
        tparams = {k: to_torch(v).to(tdt) for k, v in jparams.items()}
        out[dtype] = _run_pair(method, schedule, dtype, 3, rescale, img2img, jparams, tparams)
    got32, want32 = out["float32"]
    got16, want16 = out["bfloat16"]
    assert _err(got32, want32) <= UNET_TOL, f"{method} fp32: {_err(got32, want32)}"
    assert _err(got16, want16) <= BF16_UNET_TOL, f"{method} bf16: {_err(got16, want16)}"
    drift_port, drift_jax = _err(got16, want32), _err(want16, want32)
    assert drift_port <= BF16_DRIFT * drift_jax, f"{method}: {drift_port} vs {drift_jax}"


def _tokenize(prompts):
    """Deterministic ids below the tiny CLIP's 1000 rows (BOS 1, EOS pad 2),
    the same for both packages."""
    ids = np.full((len(prompts), 77), 2, np.int32)
    for b, prompt in enumerate(prompts):
        ids[b, 0] = 1
        for i, w in enumerate(prompt.split()[:75]):
            ids[b, i + 1] = 3 + zlib.crc32(w.encode()) % 990
    return ids


@pytest.fixture(scope="module")
def tiny_models(tiny_unet):
    vae = rand_unet_params(jvae.vae_param_shapes(jvae.VAEConfig.tiny()), seed=4)
    clip = rand_unet_params(jclip.clip_param_shapes(jclip.CLIPTextConfig.tiny()), seed=5)
    return {"unet": tiny_unet, "vae": vae, "clip": clip}


def _port_sample(models, spec, **kw):
    tparams = {name: params_from_jax(p, device="cpu") for name, p in models.items()}
    return tsampler.sample_images(tparams["unet"], tparams["vae"], tparams["clip"], _tokenize,
                                  PROMPTS, NEGATIVE, spec, steps=3, cfg_scale=CFG, width=W,
                                  height=H, device="cpu", **kw)


@pytest.mark.parametrize("method,img2img", [("ddim", False), ("euler_a", True),
                                            ("dpmpp_2m", True)])
def test_sample_images_matches_jax(method, img2img, tiny_models, monkeypatch):
    """CLIP -> sampler -> VAE decoder -> uint8 in fp32, guidance rescale 0.7,
    with JAX's draws: every pixel within one uint8 level."""
    for name in ("ddim_sample_latents", "euler_sample_latents", "dpmpp_2m_sample_latents"):
        monkeypatch.setattr(jsampler, name, getattr(jsampler, name).__wrapped__)
    js, ts = _specs("eps", "float32")
    init = (np.random.RandomState(9).uniform(-1, 1, (H, W, 3)).astype(np.float32)
            if img2img else None)
    kw = {"method": method, "init_image": init, "strength": 0.75, "guidance_rescale": 0.7}
    want = jsampler.sample_images(
        tiny_models["unet"], tiny_models["vae"], tiny_models["clip"], _tokenize, PROMPTS,
        NEGATIVE, js, steps=3, cfg_scale=CFG, width=W, height=H, seed=11, **kw)

    rng = jax.random.PRNGKey(11)
    latent = None
    if img2img:
        rng, vae_rng = jax.random.split(rng)
        latent = nchw(jax.random.normal(vae_rng, (BATCH, H // 2, W // 2, 4), jnp.float32))
    steps_run = 3 - int(3 * (1 - 0.75)) if img2img else 3
    draws = jax_draws(method, rng, js, steps_run, (BATCH, H // 2, W // 2, 4))
    draws.latent_noise = latent
    got = _port_sample(tiny_models, ts, draws=draws, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape == (BATCH, H, W, 3)
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1, f"{method}: {(diff > 1).sum()} pixels off by more than 1"


def test_sample_images_draws_from_its_generator(tiny_models):
    """Without draws: the same seed gives the same pixels, another seed
    others (the generator is seeded on the sampling device)."""
    _, ts = _specs("eps", "float32")
    a = _port_sample(tiny_models, ts, seed=5, method="euler_a")
    b = _port_sample(tiny_models, ts, seed=5, method="euler_a")
    c = _port_sample(tiny_models, ts, seed=6, method="euler_a")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    gen = torch.Generator().manual_seed(tsampler.fold_seed(5, 0))
    assert np.array_equal(_port_sample(tiny_models, ts, generator=gen, method="euler_a"),
                          _port_sample(tiny_models, ts, seed=tsampler.fold_seed(5, 0),
                                       method="euler_a"))


def _sdxl_case(ts):
    """SDXL is ported (ROADMAP 1.15): the tiny SDXL models sample with their
    second tower; the spec and params for the call that lacks it."""
    from torch_port_helpers import tiny_sdxl_models

    m = tiny_sdxl_models(vocab_size=1000)
    ts = dataclasses.replace(ts, unet_config=tunet.UNetConfig(**m.unet_config.__dict__),
                             clip_config=tclip.CLIPTextConfig(**m.clip_config.__dict__),
                             clip2_config=tclip.CLIPTextConfig(**m.clip2_config.__dict__))
    tp = {n: params_from_jax(getattr(m, n), device="cpu") for n in ("unet", "vae", "clip",
                                                                     "clip2")}
    images = tsampler.sample_images(tp["unet"], tp["vae"], tp["clip"], _tokenize, PROMPTS,
                                    NEGATIVE, ts, steps=2, cfg_scale=CFG, width=W, height=H,
                                    device="cpu", clip2_params=tp["clip2"])
    assert images.shape == (BATCH, H, W, 3) and images.dtype == np.uint8
    return ts, {"unet": m.unet, "vae": m.vae, "clip": m.clip}


@pytest.mark.parametrize("case", ["sdxl", "sd3", "flow_euler", "unknown", "cuda"])
def test_sample_images_refuses_what_is_not_ported(case, tiny_models):
    """Unknown methods raise, and flow_euler on a UNet model; SDXL and SD3
    sample (tests/test_torch_sdxl.py and tests/test_torch_sd3.py hold them
    against JAX) and refuse a call without their second tower."""
    _, ts = _specs("eps", "float32")
    kw = {}
    if case == "sdxl":
        ts, tiny_models = _sdxl_case(ts)
    elif case == "sd3":
        ts = dataclasses.replace(ts, unet_config=None, mmdit_config=tmmdit.MMDiTConfig.tiny())
    elif case in ("flow_euler", "unknown"):
        kw["method"] = case
    err = {"sdxl": (ValueError, "clip2_params"), "sd3": (ValueError, "clip2_params"),
           "flow_euler": (ValueError, "flow_euler is SD3's"), "unknown": (ValueError, "unknown"),
           "cuda": (RuntimeError, "CUDA")}[case]
    with pytest.raises(err[0], match=err[1]):
        if case == "cuda":
            if torch.cuda.is_available():
                pytest.skip("a card is present: the CUDA default is not refused")
            tsampler.sample_images({}, {}, {}, _tokenize, PROMPTS, NEGATIVE, ts)
        else:
            _port_sample(tiny_models, ts, **kw)
