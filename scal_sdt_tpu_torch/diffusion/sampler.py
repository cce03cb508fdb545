"""Sampling with classifier-free guidance (port of
``scal_sdt_tpu/diffusion/sampler.py``: the SD1.x/2.x, SDXL and SD3 samplers).

The replacement for the diffusers ``StableDiffusionPipeline`` the reference
samples with: tokenize and encode the prompts, run the denoising loop with
the CFG pair batched into one UNet call (uncond first, cond second), decode
with the VAE. Four methods for the UNet models: DDIM, Euler,
Euler-ancestral and DPM-Solver++(2M), each with guidance rescale and img2img;
the SD3 family samples with the flow-matching Euler ODE (``flow_euler``).

The JAX samplers are one ``lax.scan`` program each; here each is a Python
loop over the timestep ladder, run under ``torch.inference_mode()`` with the
UNet's remat off. The dtypes are the JAX ones: DDIM draws its noise and
carries ``x`` in ``spec.dtype`` (bf16) through the whole ladder, its
schedule constants cast to ``x``'s dtype; Euler, Euler-a and DPM++(2M) carry
``x`` in fp32, cast only the UNet's input to ``spec.dtype`` and combine the
CFG pair in fp32. Zero-terminal-SNR schedules have ``alphas_cumprod[T-1] =
0``; the sigma-space samplers clamp it at 2^-24 first, so no sigma is
infinite.

Random numbers come from an explicit ``torch.Generator`` on the sampling
device (JAX splits and folds its PRNG key, which torch cannot reproduce);
in ``sample_images`` the order is img2img's latent noise, the initial noise,
then Euler-a's per-step noise. ``SamplerDraws`` replaces them, which is how
the tests feed both packages the same numbers.

SDXL (a text_time UNet, ``clip2_params``): the prompts are encoded as in
training (both towers' raw penultimate states concatenated, tower 2's pooled
projected embedding), and every UNet call of the CFG pair takes
``added_cond``: the pooled pair (uncond first) and ``time_ids`` of
``[h, w, 0, 0, h, w]`` at the target size.

SD3 (an MMDiT, ``spec.mmdit_config``): the prompts are encoded as in
training (``models/mmdit.encode_sd3``: both projected CLIP towers, and T5 on
``tokenizer_3``'s ids when the model has it), and ``flow_euler`` (``ddim``,
the default method, selects it too, as in JAX) integrates diffusers'
FlowMatchEulerDiscreteScheduler in ``spec.dtype``: ``x += (sigma_next -
sigma) * v`` over the shifted sigma ladder, the CFG pair and its pooled
embeddings batched into one MMDiT call per step, the model timestep
``sigma * N`` taken in ``spec.dtype``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.clip import CLIPTextConfig, clip_text_apply, encode_sdxl
from ..models.functional import Params, scaled
from ..models.mmdit import MMDiTConfig, encode_sd3, mmdit_apply
from ..models.t5 import T5Config
from ..models.unet import UNetConfig, unet_apply
from ..models.vae import VAEConfig, decoder_apply, encoder_apply, latent_noise, sample_latents
from .schedule import NoiseSchedule

SAMPLER_METHODS = ("ddim", "euler", "euler_a", "dpmpp_2m", "flow_euler")
_SEED_MASK = (1 << 63) - 1


def ddim_timesteps(schedule: NoiseSchedule, num_inference_steps: int) -> np.ndarray:
    """Inference timestep ladder, diffusers scheduler semantics.

    'leading' (SD default): arange * ratio + steps_offset. 'trailing'
    (recommended for zero-terminal-SNR models, arXiv:2305.08891 §3.2):
    descending from T so sampling starts at the pure-noise step T-1.
    """
    T = schedule.num_train_timesteps
    if schedule.timestep_spacing == "trailing":
        return np.round(np.arange(T, 0, -T / num_inference_steps)).astype(np.int64) - 1
    step_ratio = T // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round().astype(np.int64)[::-1]
    return ts + schedule.steps_offset


def fold_seed(seed: int, data: int) -> int:
    """A generator seed for draw ``data`` of a run seeded ``seed``: the
    analogue of JAX's ``fold_in(PRNGKey(seed), data)``."""
    digest = hashlib.sha256(f"{int(seed)}:{int(data)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & _SEED_MASK


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    unet_config: Optional[UNetConfig]   # None for the SD3 family (mmdit_config)
    vae_config: VAEConfig
    clip_config: CLIPTextConfig
    schedule: NoiseSchedule             # a FlowSchedule for SD3
    clip_stop_at_layer: int = 1
    dtype: torch.dtype = torch.bfloat16
    # SDXL's and SD3's second text tower (pooled projection); None for SD1.x/2.x
    clip2_config: Optional[CLIPTextConfig] = None
    # SD3: the MMDiT denoiser and the optional T5 tower
    mmdit_config: Optional[MMDiTConfig] = None
    t5_config: Optional[T5Config] = None

    @property
    def sdxl(self) -> bool:
        return (self.unet_config is not None
                and self.unet_config.addition_embed_type == "text_time")

    @property
    def sd3(self) -> bool:
        return self.mmdit_config is not None


def cast_params(params: Params, dtype: torch.dtype, device) -> Params:
    """``params`` on ``device`` with every floating tensor in ``dtype`` (a
    tensor already there in that dtype is used as it is)."""
    return {k: v.to(device, dtype) if v.is_floating_point() else v.to(device)
            for k, v in params.items()}


@dataclasses.dataclass
class SamplerDraws:
    """The random numbers of one sampling call (NCHW). Any left None is
    drawn from the generator."""
    noise: Optional[torch.Tensor] = None          # initial noise (B, C, h, w)
    # Euler-a: one (B, C, h, w) draw per step of the ladder that runs
    step_noise: Optional[Sequence[torch.Tensor]] = None
    latent_noise: Optional[torch.Tensor] = None   # img2img: the VAE sample's


def _latent_shape(spec: SamplerSpec, batch: int, height: int, width: int) -> tuple:
    # spatial factor 2^(levels-1): 8 for SD VAEs, smaller for tiny test VAEs
    f = 2 ** (len(spec.vae_config.block_out_channels) - 1)
    channels = (spec.mmdit_config if spec.sd3 else spec.unet_config).in_channels
    return (batch, channels, height // f, width // f)


def _initial_noise(draws: Optional[SamplerDraws], generator: torch.Generator, shape,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if draws is not None and draws.noise is not None:
        return draws.noise.to(device, dtype)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _cfg_combine(pred_u: torch.Tensor, pred_c: torch.Tensor, cfg_scale: float,
                 guidance_rescale: float) -> torch.Tensor:
    """Classifier-free guidance with optional rescale (arXiv:2305.08891 §3.4,
    diffusers ``rescale_noise_cfg``): re-match the CFG'd prediction's
    per-sample std to the conditional prediction's, then lerp by phi. Python
    scalars are rounded to the predictions' dtype, as JAX's weak types are."""
    pred = pred_u + scaled(pred_c - pred_u, cfg_scale)
    if guidance_rescale > 0.0:
        std_c, std_cfg = _std(pred_c), _std(pred)
        rescaled = pred * (std_c / torch.clamp(std_cfg, min=1e-8))
        pred = scaled(rescaled, guidance_rescale) + scaled(pred, 1.0 - guidance_rescale)
    return pred


def _std(x: torch.Tensor) -> torch.Tensor:
    """Per-sample population std, keepdims: the variance in fp32 (as
    ``jnp.std`` takes it), rounded to x's dtype before the square root."""
    dims = tuple(range(1, x.dim()))
    xf = x.float()
    var = torch.square(xf - xf.mean(dim=dims, keepdim=True)).mean(dim=dims, keepdim=True)
    return torch.sqrt(var.to(x.dtype))


def _pred_to_eps_x0(pred: torch.Tensor, x: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor,
                    prediction_type: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(eps, x0) of a prediction at a timestep with sqrt(abar) ``sa`` and
    sqrt(1 - abar) ``sb``, both in x's dtype."""
    if prediction_type == "epsilon":
        eps = pred
        x0 = (x - sb * eps) / sa
    elif prediction_type == "v":
        x0 = sa * x - sb * pred
        eps = sb * x + sa * pred
    elif prediction_type == "sample":
        x0 = pred
        eps = (x - sa * x0) / sb
    else:
        raise ValueError(prediction_type)
    return eps, x0


def _cfg_pred(unet_params: Params, x_in: torch.Tensor, t: int, context: torch.Tensor,
              spec: SamplerSpec, cfg_scale: float, guidance_rescale: float,
              dtype: Optional[torch.dtype] = None,
              added_cond: Optional[dict] = None) -> torch.Tensor:
    """One UNet call on the CFG pair (uncond first, cond second) at timestep
    ``t``, the two predictions (widened to ``dtype`` when given) combined.
    ``added_cond``: SDXL's text_time inputs of the pair."""
    batch = x_in.shape[0]
    pair = torch.cat([x_in, x_in], dim=0)
    t_b = torch.full((2 * batch,), int(t), dtype=torch.int64, device=x_in.device)
    pred = unet_apply(unet_params, pair, t_b, context, spec.unet_config,
                      added_cond=added_cond)
    if dtype is not None:
        pred = pred.to(dtype)
    pred_u, pred_c = pred.chunk(2, dim=0)
    return _cfg_combine(pred_u, pred_c, cfg_scale, guidance_rescale)


def ddim_sample_latents(unet_params: Params, cond: torch.Tensor, uncond: torch.Tensor,
                        generator: torch.Generator, spec: SamplerSpec, num_steps: int,
                        cfg_scale: float, height: int, width: int, batch: int,
                        init_latents: Optional[torch.Tensor] = None, t_start_index: int = 0,
                        guidance_rescale: float = 0.0,
                        draws: Optional[SamplerDraws] = None,
                        added_cond: Optional[dict] = None) -> torch.Tensor:
    """Run the DDIM loop; returns the final latents (B, 4, h/8, w/8), unscaled.

    img2img: pass scaled ``init_latents`` and ``t_start_index`` (the index
    into the timestep ladder to start from; strength s maps to
    ``int(num_steps * (1 - s))``): the init is q-sampled to that level.
    """
    schedule, device = spec.schedule, cond.device
    ts = ddim_timesteps(schedule, num_steps)[t_start_index:]
    # the constants in fp32, sqrt(abar) and sqrt(1 - abar) taken in fp32 and
    # cast to x's dtype where used; taken here, not from the schedule's
    # cached tables, which a training step shares outside inference mode
    acp = torch.from_numpy(schedule.alphas_cumprod).to(device)
    sqrt_acp, sqrt_1m_acp = torch.sqrt(acp).to(spec.dtype), torch.sqrt(1.0 - acp).to(spec.dtype)
    final_acp = acp.new_ones(()) if schedule.set_alpha_to_one else acp[0]

    noise = _initial_noise(draws, generator, _latent_shape(spec, batch, height, width),
                           spec.dtype, device)
    if init_latents is None:
        x = noise
    else:  # q-sample the init to ts[0], as the schedule's add_noise does
        t0 = int(ts[0])
        x = sqrt_acp[t0] * init_latents.to(spec.dtype) + sqrt_1m_acp[t0] * noise

    context = torch.cat([uncond, cond], dim=0).to(spec.dtype)
    for t in ts:
        t = int(t)
        prev_t = t - schedule.num_train_timesteps // num_steps
        pred = _cfg_pred(unet_params, x, t, context, spec, cfg_scale, guidance_rescale,
                         added_cond=added_cond)
        eps, x0 = _pred_to_eps_x0(pred, x, sqrt_acp[t], sqrt_1m_acp[t],
                                  schedule.prediction_type)
        if schedule.clip_sample:
            x0 = torch.clamp(x0, -1.0, 1.0)
        acp_prev = (acp[prev_t] if prev_t >= 0 else final_acp).to(x.dtype)
        x = torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * eps
    return x


def _denoised_from_pred(x: torch.Tensor, sig: torch.Tensor, pred: torch.Tensor,
                        prediction_type: str) -> torch.Tensor:
    """Model prediction -> denoised x0 in k-diffusion sigma space
    (x = x0 + sigma*eps; the UNet saw x / sqrt(sigma^2+1))."""
    if prediction_type == "epsilon":
        return x - sig * pred
    if prediction_type == "v":
        return x / (sig ** 2 + 1.0) - pred * sig / torch.sqrt(sig ** 2 + 1.0)
    raise ValueError(f"sigma-space samplers do not support "
                     f"prediction_type={prediction_type!r}")


def _sigmas(schedule: NoiseSchedule, ts: np.ndarray, device: torch.device
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 sigmas of the ladder and the next step's (0 after the last).
    Zero-terminal-SNR models have abar[T-1] == 0 (sigma = inf): abar is
    clamped at 2^-24 first, as diffusers' EulerDiscreteScheduler does."""
    acp = torch.from_numpy(np.maximum(schedule.alphas_cumprod, 2.0 ** -24)
                           .astype(np.float32)).to(device)
    a = acp[torch.from_numpy(ts).to(device)]
    sigmas = torch.sqrt((1.0 - a) / a)
    return sigmas, torch.cat([sigmas[1:], sigmas.new_zeros(1)])


def _sigma_init(init_latents: Optional[torch.Tensor], noise: torch.Tensor,
                sig0: torch.Tensor) -> torch.Tensor:
    if init_latents is None:
        # init_noise_sigma: the VP sample at T is N(0,1); in sigma space
        # that is sqrt(sigma_max^2 + 1) * N(0,1)
        return noise * torch.sqrt(sig0 ** 2 + 1.0)
    # img2img: x = x0 + sigma_start * eps (k-diffusion convention)
    return init_latents.float() + noise * sig0


def euler_sample_latents(unet_params: Params, cond: torch.Tensor, uncond: torch.Tensor,
                         generator: torch.Generator, spec: SamplerSpec, num_steps: int,
                         cfg_scale: float, height: int, width: int, batch: int,
                         ancestral: bool = False, init_latents: Optional[torch.Tensor] = None,
                         t_start_index: int = 0, guidance_rescale: float = 0.0,
                         draws: Optional[SamplerDraws] = None,
                        added_cond: Optional[dict] = None) -> torch.Tensor:
    """Euler / Euler-ancestral (k-diffusion style on the discrete VP sigmas,
    diffusers EulerDiscreteScheduler semantics), the WebUI ecosystem's
    default samplers.

    Sigma-space convention: x = x0 + sigma*eps; the UNet consumes
    x / sqrt(sigma^2+1) at the discrete timestep of that sigma.
    """
    schedule, device = spec.schedule, cond.device
    if schedule.prediction_type == "sample":
        raise ValueError("euler samplers do not support prediction_type=sample")
    ts = ddim_timesteps(schedule, num_steps)[t_start_index:]
    sigmas, sigmas_next = _sigmas(schedule, ts, device)
    shape = _latent_shape(spec, batch, height, width)
    x = _sigma_init(init_latents, _initial_noise(draws, generator, shape, torch.float32, device),
                    sigmas[0])

    context = torch.cat([uncond, cond], dim=0).to(spec.dtype)
    for i, t in enumerate(ts):
        sig, sig_n = sigmas[i], sigmas_next[i]
        x_in = (x / torch.sqrt(sig ** 2 + 1.0)).to(spec.dtype)
        pred = _cfg_pred(unet_params, x_in, t, context, spec, cfg_scale, guidance_rescale,
                         dtype=torch.float32, added_cond=added_cond)
        denoised = _denoised_from_pred(x, sig, pred, schedule.prediction_type)
        d = (x - denoised) / sig
        if ancestral:
            var = sig_n ** 2 * (sig ** 2 - sig_n ** 2) / sig ** 2
            sig_up = torch.sqrt(var)
            sig_down = torch.sqrt(sig_n ** 2 - var)
            if draws is not None and draws.step_noise is not None:
                noise = draws.step_noise[i].to(device, torch.float32)
            else:
                noise = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                                    device=device)
            x = x + d * (sig_down - sig) + noise * sig_up
        else:
            x = x + d * (sig_n - sig)
    # sigma 0 reached: x IS the denoised latent
    return x.to(spec.dtype)


def dpmpp_2m_sample_latents(unet_params: Params, cond: torch.Tensor, uncond: torch.Tensor,
                            generator: torch.Generator, spec: SamplerSpec, num_steps: int,
                            cfg_scale: float, height: int, width: int, batch: int,
                            init_latents: Optional[torch.Tensor] = None,
                            t_start_index: int = 0, guidance_rescale: float = 0.0,
                            draws: Optional[SamplerDraws] = None,
                        added_cond: Optional[dict] = None) -> torch.Tensor:
    """DPM-Solver++(2M) (arXiv:2211.01095; k-diffusion ``sample_dpmpp_2m``):
    second-order multistep on log-sigma, one UNet call per step, reusing
    the previous step's denoised estimate."""
    schedule, device = spec.schedule, cond.device
    ts = ddim_timesteps(schedule, num_steps)[t_start_index:]
    sigmas, sigmas_next = _sigmas(schedule, ts, device)
    shape = _latent_shape(spec, batch, height, width)
    x = _sigma_init(init_latents, _initial_noise(draws, generator, shape, torch.float32, device),
                    sigmas[0])

    context = torch.cat([uncond, cond], dim=0).to(spec.dtype)
    old_denoised, sig_prev = torch.zeros_like(x), sigmas[0]
    for i, t in enumerate(ts):
        sig, sig_n = sigmas[i], sigmas_next[i]
        x_in = (x / torch.sqrt(sig ** 2 + 1.0)).to(spec.dtype)
        pred = _cfg_pred(unet_params, x_in, t, context, spec, cfg_scale, guidance_rescale,
                         dtype=torch.float32, added_cond=added_cond)
        denoised = _denoised_from_pred(x, sig, pred, schedule.prediction_type)

        # t(sigma) = -log(sigma); at the final step sigma_next = 0 so h = inf
        # and expm1(-h) reaches its exact limit -1: x becomes denoised_d.
        tt, tn = -torch.log(sig), -torch.log(sig_n)
        h = tn - tt
        # the second-order correction uses the previous denoised estimate;
        # the first step has none and the final step (h = inf) degenerates:
        # a plain first-order step in both cases (k-diffusion's
        # `old_denoised is None or sigmas[i+1] == 0`). Both branches are
        # evaluated, so r_safe keeps inf/inf out of the unused one.
        second = (sig_n > 0.0) & (i > 0)
        h_last = tt + torch.log(sig_prev)
        r_safe = torch.where(second, h_last / h, torch.ones_like(h))
        c = 1.0 / (2.0 * r_safe)
        denoised_d = torch.where(second, (1.0 + c) * denoised - c * old_denoised, denoised)
        x = (sig_n / sig) * x - torch.expm1(-h) * denoised_d
        old_denoised, sig_prev = denoised, sig
    return x.to(spec.dtype)


def flow_euler_sample_latents(mmdit_params: Params, cond: torch.Tensor, uncond: torch.Tensor,
                              pooled: torch.Tensor, pooled_u: torch.Tensor,
                              generator: torch.Generator, spec: SamplerSpec, num_steps: int,
                              cfg_scale: float, height: int, width: int, batch: int,
                              init_latents: Optional[torch.Tensor] = None,
                              t_start_index: int = 0, guidance_rescale: float = 0.0,
                              draws: Optional[SamplerDraws] = None) -> torch.Tensor:
    """The SD3 family's flow-matching Euler ODE (diffusers
    FlowMatchEulerDiscreteScheduler.step): ``x <- x + (sigma_next - sigma)
    * v`` in ``spec.dtype``, with the CFG pair batched through the MMDiT.
    img2img: ``init_latents`` (scaled) start at ``sigma[t_start_index]``,
    ``(1 - sigma) init + sigma noise``."""
    device = cond.device
    sigmas = spec.schedule.sampling_sigmas(num_steps).to(device, spec.dtype)
    noise = _initial_noise(draws, generator, _latent_shape(spec, batch, height, width),
                           spec.dtype, device)
    if init_latents is None:
        x = noise  # sigma(0) = 1: pure noise
    else:
        sig0 = sigmas[t_start_index]
        x = (1.0 - sig0) * init_latents.to(spec.dtype) + sig0 * noise

    context = torch.cat([uncond, cond], dim=0).to(spec.dtype)
    pooled_all = torch.cat([pooled_u, pooled], dim=0).to(spec.dtype)
    n = spec.schedule.num_train_timesteps
    for i in range(t_start_index, num_steps):
        sig, sig_next = sigmas[i], sigmas[i + 1]
        t = (sig * n).float().expand(2 * batch)
        v = mmdit_apply(mmdit_params, torch.cat([x, x], dim=0), t, context, pooled_all,
                        spec.mmdit_config)
        v_u, v_c = v.chunk(2, dim=0)
        v = _cfg_combine(v_u, v_c, cfg_scale, guidance_rescale)
        x = x + (sig_next - sig) * v.to(x.dtype)
    return x


_LOOPS = {
    "ddim": ddim_sample_latents,
    "euler": euler_sample_latents,
    "euler_a": lambda *a, **k: euler_sample_latents(*a, ancestral=True, **k),
    "dpmpp_2m": dpmpp_2m_sample_latents,
}


def sample_images(unet_params: Params, vae_params: Params, clip_params: Params,
                  tokenizer, prompts: list[str], negative_prompt: str, spec: SamplerSpec,
                  steps: int = 28, cfg_scale: float = 7.5, width: int = 512, height: int = 512,
                  seed: Optional[int] = None, generator: Optional[torch.Generator] = None,
                  method: str = "ddim", init_image: Optional[np.ndarray] = None,
                  strength: float = 0.75, guidance_rescale: float = 0.0,
                  draws: Optional[SamplerDraws] = None, device="cuda",
                  clip2_params: Optional[Params] = None, t5_params: Optional[Params] = None,
                  tokenizer_3=None) -> np.ndarray:
    """Full text -> image path on ``device``. Returns uint8 (B, H, W, 3).

    Every floating parameter is cast to ``spec.dtype`` on ``device`` (a
    tensor already there in that dtype is used as it is). ``generator``
    (else one seeded with ``seed``, default 0) draws the noise; ``draws``
    replaces its draws.

    img2img: ``init_image`` is (H, W, 3) or (B, H, W, 3) float in [-1, 1];
    ``strength`` in (0, 1] controls how much of the denoising ladder runs
    (1.0 ignores the init, like diffusers' Img2ImgPipeline).

    SDXL: pass ``clip2_params`` (the text_encoder_2 tower). SD3: pass
    ``clip2_params`` and, for a model with T5, ``t5_params`` and
    ``tokenizer_3``; the method is ``flow_euler`` (or ``ddim``, which
    selects it).
    """
    if (spec.sdxl or spec.sd3) and clip2_params is None:
        raise ValueError("SDXL and SD3 sampling require clip2_params (the text_encoder_2 "
                         "tower)")
    if spec.sd3:
        if method not in ("flow_euler", "ddim"):
            raise ValueError(f"SD3 models sample with method 'flow_euler' (got {method!r})")
        if t5_params is not None and tokenizer_3 is None:
            raise ValueError("SD3 model has a T5 tower: pass tokenizer_3")
    elif method not in _LOOPS:
        raise ValueError(f"Unknown sampler method {method!r}; choose from "
                         f"{SAMPLER_METHODS[:-1]} (flow_euler is SD3's)")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0 if seed is None else int(seed))
    batch = len(prompts)

    def cast(p: Params) -> Params:
        return cast_params(p, spec.dtype, dev)

    with torch.inference_mode():
        ids = torch.from_numpy(np.asarray(tokenizer(prompts), np.int64)).to(dev)
        neg_ids = torch.from_numpy(np.asarray(tokenizer([negative_prompt] * batch),
                                              np.int64)).to(dev)
        clip_c = cast(clip_params)
        added_cond = None
        if spec.sd3:
            clip2_c = cast(clip2_params)
            t5_c = cast(t5_params) if t5_params is not None else None

            def encode(ids_, prompts_):
                t5 = {}
                if t5_c is not None:
                    t5_ids = torch.from_numpy(np.asarray(tokenizer_3(prompts_), np.int64)).to(dev)
                    t5 = {"t5_params": t5_c, "t5_ids": t5_ids, "t5_config": spec.t5_config}
                emb, pooled = encode_sd3(clip_c, clip2_c, ids_, spec.clip_config,
                                         spec.clip2_config, spec.mmdit_config.joint_attention_dim,
                                         **t5)
                return emb.to(spec.dtype), pooled.to(spec.dtype)

            cond, pooled_c = encode(ids, list(prompts))
            uncond, pooled_u = encode(neg_ids, [negative_prompt] * batch)
            del clip2_c, t5_c
        elif spec.sdxl:
            clip2_c = cast(clip2_params)
            cond, pooled_c = encode_sdxl(clip_c, clip2_c, ids, spec.clip_config,
                                         spec.clip2_config)
            uncond, pooled_u = encode_sdxl(clip_c, clip2_c, neg_ids, spec.clip_config,
                                           spec.clip2_config)
            del clip2_c
            time_ids = torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32,
                                    device=dev).expand(2 * batch, 6)
            added_cond = {"text_embeds": torch.cat([pooled_u, pooled_c]).to(spec.dtype),
                          "time_ids": time_ids}
        else:
            cond = clip_text_apply(clip_c, ids, spec.clip_config, spec.clip_stop_at_layer)
            uncond = clip_text_apply(clip_c, neg_ids, spec.clip_config,
                                     spec.clip_stop_at_layer)
        del clip_c
        vae_c = cast(vae_params)

        init_latents, t_start = None, 0
        if init_image is not None:
            img = torch.as_tensor(np.asarray(init_image, np.float32), device=dev)
            if img.dim() == 3:
                img = img[None]
            img = img.permute(0, 3, 1, 2).expand(batch, -1, -1, -1)
            moments = encoder_apply(vae_c, img.to(spec.dtype), spec.vae_config)
            noise = (draws.latent_noise.to(dev, moments.dtype)
                     if draws is not None and draws.latent_noise is not None
                     else latent_noise(moments, generator))
            init_latents = sample_latents(moments, noise, spec.vae_config.scaling_factor,
                                          spec.vae_config.shift_factor)
            t_start = min(int(steps * (1.0 - float(strength))), steps - 1)

        loop_args = dict(init_latents=init_latents, t_start_index=t_start,
                         guidance_rescale=float(guidance_rescale), draws=draws)
        if spec.sd3:
            latents = flow_euler_sample_latents(
                cast(unet_params), cond, uncond, pooled_c, pooled_u, generator, spec,
                int(steps), float(cfg_scale), int(height), int(width), batch, **loop_args)
        else:
            latents = _LOOPS[method](cast(unet_params), cond, uncond, generator, spec,
                                     int(steps), float(cfg_scale), int(height), int(width),
                                     batch, added_cond=added_cond, **loop_args)
        z = latents / latents.new_full((), spec.vae_config.scaling_factor)
        if spec.vae_config.shift_factor:
            z = z + z.new_full((), spec.vae_config.shift_factor)
        images = decoder_apply(vae_c, z, spec.vae_config)
        images = (torch.clamp(images.float(), -1.0, 1.0) + 1.0) * 127.5
        return images.permute(0, 2, 3, 1).cpu().numpy().astype(np.uint8)
