"""The training step (port of ``scal_sdt_tpu/training/step.py``: the
SD1.x/2.x, SDXL and SD3 branches).

``compute_loss`` takes latents from the batch (cached) or from the VAE
encoder and a sample of its Gaussian (``images``), conditionings from the
batch (cached) or from CLIP (``input_ids``) with CFG dropout (``uncond``:
one draw per batch drops the whole batch, to the empty prompt's ids in mode
'eos' or to zero conds in mode 'zeros'). SDXL (a text_time UNet,
``StepSpec.clip2_config``): the conds are both towers' raw penultimate
states concatenated (tower 2's ids zeroed after the first EOS, as SDXL's
second tokenizer pads), the pooled projected embedding of tower 2 and the
size ids (``size_cond`` of the batch, or the target size with zero crop)
feed the UNet's text_time embedding; CFG dropout 'zeros' drops the pooled
embedding with the conds; a cached SDXL batch carries ``pooled``. SD3 (an
MMDiT, ``StepSpec.mmdit_config``, under a ``FlowSchedule``): the conds are
``models/mmdit.encode_sd3`` of both projected CLIP towers and, when the
model has it (``t5_config``), T5 on ``t5_ids`` (T5's own empty-prompt ids
under 'eos'); the pooled embedding feeds the MMDiT's adaLN; a cached SD3
batch carries ``pooled``; CFG dropout 'zeros' zeroes both. Then q-sample
(with the optional noise offset and multires noise), the denoiser (the UNet
or the MMDiT), MSE against the schedule target in fp32 (the flow velocity
for SD3), optional min-SNR weighting (refused under flow) and prior
preservation. ``make_train_step``
takes gradients with respect to a compute-dtype copy of the trainable dict
(bf16 gradients, as in the JAX step), then runs the optimizer and applies
the update to the masters in fused launches (``tx.update_and_apply``: one
``adam_bf16_fused`` launch over every Adam group's leaves): bf16 masters take the fp32 add and a
stochastically rounded store salted ``crc32(key) ^ 0xE3A0001``, bit for bit
the JAX dither. The masters are updated in place, as the JAX step donates
them. ``apply_updates`` is that apply as a plain chain over the updates of
``tx.update``.

With ``ema_enabled`` the step then updates the EMA shadow of the ``unet.*``
masters (``training/ema.py``), one launch over every shadow, on every call:
under gradient accumulation the micro-steps that emit no update count too,
as in the JAX step.

The JAX step draws from ``fold_in(rng, step)``; torch cannot reproduce that
stream, so the port draws from an explicit ``torch.Generator`` and accepts
the draws from the caller instead (``Draws``), which is how the tests feed
both the same numbers. The generator's order: the LoRA dropout's base seed
(only while a LoRA dropout rate is set), the latent noise (after the
encode), the CFG-dropout scalar, then noise, timesteps, offset and octaves.
Each LoRA layer draws its dropout mask from a generator of its own seeded
from the base seed and its name (``models/functional.py`` ``LoRADropout``),
so the recompute of a checkpointed block draws the same mask; the UNet and
both text towers share the base seed, as they share JAX's ``rng_lora`` (SD3's
T5 takes no LoRA dropout, as in JAX). Timesteps are integers under a DDPM
schedule and fp32 floats under the flow schedule.

Over several ranks (``parallel``, a ``parallel/sharding.py`` ``Parallel``)
each rank holds its rows of the global batch: the draws are made (or given)
for the whole batch and each rank takes its rows, the denoiser runs the
rank's tensor-parallel view, the gradients are averaged over the
data-parallel ranks, and each rank updates the masters it owns, whose
compute-dtype copies (``TrainState.compute``) are then broadcast.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..conf import Config
from ..diffusion.schedule import NoiseSchedule
from ..models.clip import CLIPTextConfig, clip_text_apply, encode_sdxl
from ..models.functional import LORA_DROPOUT, LoRADropout, Params, lora_dropout_rates, scaled
from ..models.mmdit import MMDiTConfig, encode_sd3, mmdit_apply
from ..models.t5 import T5Config
from ..models.unet import UNetConfig, unet_apply
from ..models.vae import VAEConfig, encoder_apply, latent_noise, sample_latents
from ..ops.sr import MASTER_SALT, apply_update_reference, leaf_salt
from .ema import EMAState, ema_init, ema_update
from .optimizers import AccumulationState
from ..parallel.tensor import tp_view
from ..utils import tracing
from .optim_targets import COMPONENT_PREFIX

UNET_PREFIX = COMPONENT_PREFIX["unet"]
TE_PREFIX = COMPONENT_PREFIX["text_encoder"]
TE2_PREFIX = COMPONENT_PREFIX["text_encoder_2"]
TE3_PREFIX = COMPONENT_PREFIX["text_encoder_3"]
VAE_PREFIX = "vae"
UNCOND_MODES = ("zeros", "eos")


class TrainState(NamedTuple):
    step: int                     # host-side step count
    trainable: Params             # prefixed flat dict (masters)
    opt_state: object
    generator: torch.Generator    # draws noise and timesteps, on the params' device
    ema: Optional[EMAState] = None  # over the trainable unet.* masters
    # sharded masters: the compute-dtype copy of every trainable (owned or not)
    compute: Optional[Params] = None


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """Static configuration of the step."""
    unet_config: Optional[UNetConfig]   # None for SD3 (mmdit_config)
    schedule: NoiseSchedule             # a FlowSchedule for SD3
    compute_dtype: torch.dtype
    remat: object = False     # False | True | 'high' | 'top' (see unet_apply)
    prior_preservation: bool = False
    prior_loss_weight: float = 1.0
    min_snr_gamma: Optional[float] = None
    noise_offset: float = 0.0
    multires_noise_iterations: int = 0
    multires_noise_discount: float = 0.25
    # the uncached branch: the VAE that encodes 'images', the text encoder
    # that encodes 'input_ids' (None: a cached run needs neither)
    vae_config: Optional[VAEConfig] = None
    clip_config: Optional[CLIPTextConfig] = None
    clip_stop_at_layer: int = 1
    uncond_enabled: bool = False
    uncond_p: float = 0.1
    uncond_mode: str = "zeros"        # 'zeros' | 'eos'
    train_text_encoder: bool = False
    # SDXL's and SD3's second text tower (None for SD1.x/2.x)
    clip2_config: Optional[CLIPTextConfig] = None
    # SD3: the MMDiT denoiser and the optional T5 tower
    mmdit_config: Optional[MMDiTConfig] = None
    t5_config: Optional[T5Config] = None

    def __post_init__(self):
        if self.uncond_mode not in UNCOND_MODES:
            raise ValueError(f"uncond.cond must be one of {UNCOND_MODES}, "
                             f"got {self.uncond_mode!r}")

    @property
    def sdxl(self) -> bool:
        return (self.unet_config is not None
                and self.unet_config.addition_embed_type == "text_time")

    @property
    def sd3(self) -> bool:
        return self.mmdit_config is not None

    @classmethod
    def from_config(cls, config: Config, unet_config: Optional[UNetConfig],
                    schedule: Optional[NoiseSchedule] = None, *,
                    vae_config: Optional[VAEConfig] = None,
                    clip_config: Optional[CLIPTextConfig] = None,
                    train_text_encoder: bool = False,
                    clip2_config: Optional[CLIPTextConfig] = None,
                    mmdit_config: Optional[MMDiTConfig] = None,
                    t5_config: Optional[T5Config] = None) -> "StepSpec":
        precision = config.trainer.get("precision", "bf16")
        loss = config.get("loss") or {}
        gc = config.get("gradient_checkpointing", False)
        uncond = config.get("uncond") or {}
        return cls(
            unet_config=unet_config,
            schedule=schedule if schedule is not None else NoiseSchedule(),
            compute_dtype=torch.float32 if str(precision) == "32" else torch.bfloat16,
            remat=gc if gc in (True, False, "high", "top") else bool(gc),
            prior_preservation=bool(config.prior_preservation.get("enabled", False)),
            prior_loss_weight=float(config.prior_preservation.get("prior_loss_weight", 1.0)),
            min_snr_gamma=(float(loss["min_snr_gamma"]) if loss.get("min_snr_gamma")
                           else None),
            noise_offset=float(loss.get("noise_offset") or 0.0),
            multires_noise_iterations=int(loss.get("multires_noise_iterations") or 0),
            multires_noise_discount=float(loss.get("multires_noise_discount") or 0.25),
            vae_config=vae_config,
            clip_config=clip_config,
            clip_stop_at_layer=int(config.get("clip_stop_at_layer", 1)),
            uncond_enabled=bool(uncond.get("enabled", False)),
            uncond_p=float(uncond.get("p", 0.1)),
            uncond_mode=uncond.get("cond", "zeros"),
            train_text_encoder=train_text_encoder,
            clip2_config=clip2_config,
            mmdit_config=mmdit_config,
            t5_config=t5_config,
        )


@dataclasses.dataclass
class Draws:
    """The random numbers of one ``compute_loss`` call (NCHW)."""
    noise: torch.Tensor                      # (B, C, h, w)
    timesteps: torch.Tensor                  # (B,) integer, or fp32 under flow
    offset: Optional[torch.Tensor] = None    # (B, C, 1, 1), with noise_offset
    octaves: tuple[torch.Tensor, ...] = ()   # multires octaves, coarsest last
    latent_noise: Optional[torch.Tensor] = None  # (B, C, h, w), with 'images'
    uncond_u: Optional[torch.Tensor] = None  # 0-dim uniform, with uncond on
    # LoRA dropout (while a rate is set): per-layer keep masks in each layer
    # input's layout, by component-relative layer name
    lora_masks: Optional[dict[str, torch.Tensor]] = None


def _octave_sizes(h: int, w: int, iterations: int) -> list[tuple[int, int]]:
    sizes = []
    for i in range(1, iterations + 1):
        hi, wi = max(1, h // (2 ** i)), max(1, w // (2 ** i))
        sizes.append((hi, wi))
        if hi == 1 and wi == 1:
            break
    return sizes


def draw(generator: torch.Generator, spec: StepSpec, latents: torch.Tensor,
         latent_noise: Optional[torch.Tensor] = None,
         uncond_u: Optional[torch.Tensor] = None, rows=None) -> Draws:
    """Fresh draws for one step from ``generator`` (the uncached branch's
    latent noise and CFG-dropout scalar, drawn before, are handed in).
    ``rows`` (a ``Rows``): draw for the whole batch, keep the rank's rows."""
    b, c, h, w = latents.shape
    dt, dev = spec.compute_dtype, latents.device
    if rows is not None:
        b = rows.total

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dt, device=dev)

    draws = Draws(
        noise=normal(b, c, h, w),
        timesteps=spec.schedule.sample_timesteps(generator, b, dev),
        offset=normal(b, c, 1, 1) if spec.noise_offset else None,
        octaves=tuple(normal(b, c, hi, wi) for hi, wi in
                      _octave_sizes(h, w, spec.multires_noise_iterations)),
    )
    if rows is not None:
        draws = select_rows(draws, rows)
    return dataclasses.replace(draws, latent_noise=latent_noise, uncond_u=uncond_u)


def select_rows(draws: Draws, rows) -> Draws:
    """The rank's rows of draws made for the whole batch (the CFG-dropout
    scalar is the batch's; LoRA masks of the batch's layout lose the other
    rows)."""
    def take(t):
        return rows.take(t) if t is not None else None

    masks = draws.lora_masks
    if masks is not None:
        masks = {k: take(m) if m.shape[0] == rows.total else m for k, m in masks.items()}
    return dataclasses.replace(
        draws, noise=take(draws.noise), timesteps=take(draws.timesteps),
        offset=take(draws.offset), octaves=tuple(take(o) for o in draws.octaves),
        latent_noise=take(draws.latent_noise), lora_masks=masks)


def _multires_noise(noise: torch.Tensor, octaves, discount: float) -> torch.Tensor:
    """Pyramid noise: bilinearly upsampled octaves weighted discount^i, then
    each sample renormalised to unit std (population std, fp32)."""
    total = noise
    for i, octave in enumerate(octaves, start=1):
        up = F.interpolate(octave, size=noise.shape[2:], mode="bilinear", align_corners=False)
        total = total + scaled(up, discount ** i)
    std = total.float().std(dim=(1, 2, 3), keepdim=True, correction=0)
    return total / torch.clamp(std, min=1e-8).to(noise.dtype)


def _merged_component(trainable: Params, frozen: Params, prefix: str, dtype) -> Params:
    """Component view of frozen + trainable, floating tensors cast to dtype."""
    cut = len(prefix) + 1
    out: Params = {}
    for source in (frozen, trainable):
        for k, v in source.items():
            if k.startswith(prefix + "."):
                out[k[cut:]] = v.to(dtype) if v.is_floating_point() else v
    return out


def _encode_latents(trainable: Params, frozen: Params, images: torch.Tensor,
                    spec: StepSpec, generator, draws: Optional[Draws], rows=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(latents, the latent noise they took): VAE moments of ``images``,
    then a sample of their Gaussian (its noise drawn for the whole batch
    and cut to the rank's ``rows``, when given)."""
    if spec.vae_config is None:
        raise ValueError("a batch of images needs StepSpec.vae_config")
    dt = spec.compute_dtype
    vae_params = _merged_component(trainable, frozen, VAE_PREFIX, dt)
    moments = encoder_apply(vae_params, images.to(dt), spec.vae_config)
    if draws is not None:
        noise = draws.latent_noise
    elif rows is not None:
        noise = rows.take(latent_noise(moments.new_empty((rows.total,) + moments.shape[1:]),
                                       generator))
    else:
        noise = latent_noise(moments, generator)
    return sample_latents(moments, noise, spec.vae_config.scaling_factor,
                          spec.vae_config.shift_factor), noise


def lora_dropout(generator: Optional[torch.Generator], draws: Optional[Draws]
                 ) -> Optional[LoRADropout]:
    """The step's LoRA dropout (None while no rate is set): the masks of
    ``draws``, else a base seed drawn from ``generator``."""
    if not lora_dropout_rates():
        return None
    if draws is not None:
        if draws.lora_masks is None:
            raise ValueError("LoRA dropout is on: the draws need lora_masks")
        return LoRADropout(masks=draws.lora_masks)
    seed = torch.randint(0, 1 << 62, (), generator=generator, device=generator.device)
    return LoRADropout(int(seed))


def _encode_conds(trainable: Params, frozen: Params, batch: dict, spec: StepSpec,
                  uncond_u: Optional[torch.Tensor], dropout: Optional[LoRADropout] = None
                  ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(conds, pooled) of ``input_ids`` with CFG dropout: when ``uncond_u <
    p`` the whole batch is dropped, to the empty prompt's ids ('eos', before
    any tower sees them) or to zero conds and pooled embedding ('zeros').
    SD1.x/2.x: CLIP at ``clip_stop_at_layer``, no pooled embedding; SDXL:
    both towers (``encode_sdxl``); SD3: both towers and T5 (``encode_sd3``),
    T5's ids dropped to ``t5_uncond_ids`` in mode 'eos'."""
    if spec.clip_config is None or ((spec.sdxl or spec.sd3) and spec.clip2_config is None):
        raise ValueError("a batch of input_ids needs StepSpec.clip_config (and for SDXL "
                         "and SD3 clip2_config)")
    dt = spec.compute_dtype
    te_params = _merged_component(trainable, frozen, TE_PREFIX, dt)
    if dropout is not None:
        te_params[LORA_DROPOUT] = dropout
    input_ids = batch["input_ids"]
    drop = uncond_u < spec.uncond_p if spec.uncond_enabled else None
    if drop is not None and spec.uncond_mode == "eos":
        input_ids = torch.where(drop, batch["uncond_ids"].expand_as(input_ids), input_ids)
    if spec.sdxl or spec.sd3:
        te2_params = _merged_component(trainable, frozen, TE2_PREFIX, dt)
        if dropout is not None:
            te2_params[LORA_DROPOUT] = dropout
    if spec.sd3:
        t5 = {}
        if spec.t5_config is not None:
            t5_ids = batch["t5_ids"]
            if drop is not None and spec.uncond_mode == "eos" and "t5_uncond_ids" in batch:
                t5_ids = torch.where(drop, batch["t5_uncond_ids"].expand_as(t5_ids), t5_ids)
            t5 = {"t5_params": _merged_component(trainable, frozen, TE3_PREFIX, dt),
                  "t5_ids": t5_ids, "t5_config": spec.t5_config}
        conds, pooled = encode_sd3(te_params, te2_params, input_ids, spec.clip_config,
                                   spec.clip2_config, spec.mmdit_config.joint_attention_dim,
                                   **t5)
    elif spec.sdxl:
        conds, pooled = encode_sdxl(te_params, te2_params, input_ids, spec.clip_config,
                                    spec.clip2_config)
    else:
        conds = clip_text_apply(te_params, input_ids, spec.clip_config, spec.clip_stop_at_layer)
        pooled = None
    if drop is not None and spec.uncond_mode == "zeros":
        conds = torch.where(drop, torch.zeros_like(conds), conds)
        if pooled is not None:
            pooled = torch.where(drop, torch.zeros_like(pooled), pooled)
    return conds, pooled


def size_time_ids(latents: torch.Tensor, spec: StepSpec,
                  size_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SDXL's (B, 6) fp32 ``time_ids``: [orig_h, orig_w, crop_top,
    crop_left] from ``size_cond`` (else the target size and zero crop), then
    the target size, the image size of ``latents``."""
    f = 2 ** (len(spec.vae_config.block_out_channels) - 1)
    h, w = latents.shape[2] * f, latents.shape[3] * f
    b, dev = latents.shape[0], latents.device
    target = torch.tensor([h, w], dtype=torch.float32, device=dev).expand(b, 2)
    if size_cond is None:
        size_cond = torch.tensor([h, w, 0, 0], dtype=torch.float32, device=dev).expand(b, 4)
    return torch.cat([size_cond.to(torch.float32), target], dim=-1)


def compute_loss(trainable: Params, frozen: Params, batch: dict,
                 generator: Optional[torch.Generator], spec: StepSpec,
                 draws: Optional[Draws] = None, parallel=None) -> tuple[torch.Tensor, dict]:
    """The training loss of one batch.

    batch: 'latents' (B, C, h, w) pre-scaled or 'images' (B, 3, H, W) in
    [-1, 1]; 'conds' (B, L, D) or 'input_ids' (B, L) integer, with
    'uncond_ids' (1, L) (the empty prompt's ids) for uncond mode 'eos';
    SDXL and SD3 caches carry 'pooled' (B, D2); SD3 with T5 takes 't5_ids'
    (B, L3) and 't5_uncond_ids' (1, L3). ``draws`` replaces the generator's
    draws when given. ``parallel``: the batch is the rank's rows (``draws``
    are the whole batch's), the denoiser runs its tensor-parallel view."""
    dt = spec.compute_dtype
    latent_noise_ = uncond_u = None
    rows = parallel.rows if parallel is not None else None
    if draws is not None and rows is not None:
        draws = select_rows(draws, rows)
    dropout = lora_dropout(generator, draws)
    if "latents" in batch:
        latents = batch["latents"].to(dt)
    else:
        latents, latent_noise_ = _encode_latents(trainable, frozen, batch["images"], spec,
                                                 generator, draws, rows)
    if draws is not None:
        uncond_u = draws.uncond_u
    elif spec.uncond_enabled and "conds" not in batch:
        uncond_u = torch.rand((), generator=generator, device=latents.device)
    added_cond = pooled = None
    if "conds" in batch:
        conds = batch["conds"].to(dt)
        if spec.sd3:
            pooled = batch["pooled"].to(dt)
        elif spec.sdxl:
            added_cond = {"text_embeds": batch["pooled"].to(dt),
                          "time_ids": size_time_ids(latents, spec)}
    else:
        conds, pooled = _encode_conds(trainable, frozen, batch, spec, uncond_u, dropout)
        if spec.sdxl:
            added_cond = {"text_embeds": pooled.to(dt),
                          "time_ids": size_time_ids(latents, spec, batch.get("size_cond"))}
    if draws is None:
        draws = draw(generator, spec, latents, latent_noise_, uncond_u, rows)

    noise = draws.noise.to(dt)
    if spec.noise_offset:
        noise = noise + scaled(draws.offset.to(dt), spec.noise_offset)
    if spec.multires_noise_iterations > 0:
        noise = _multires_noise(noise, [o.to(dt) for o in draws.octaves],
                                spec.multires_noise_discount)
    timesteps = draws.timesteps
    noisy = spec.schedule.add_noise(latents, noise, timesteps)

    unet_params = _merged_component(trainable, frozen, UNET_PREFIX, dt)
    if parallel is not None and parallel.tp is not None:
        unet_params = tp_view(unet_params, parallel.tp)
    if dropout is not None:
        unet_params[LORA_DROPOUT] = dropout
    if spec.sd3:
        pred = mmdit_apply(unet_params, noisy, timesteps, conds, pooled.to(dt),
                           spec.mmdit_config)
    else:
        pred = unet_apply(unet_params, noisy, timesteps, conds, spec.unet_config,
                          remat=spec.remat, added_cond=added_cond)

    target = spec.schedule.training_target(latents, noise, timesteps)
    per_elem = torch.square(pred.float() - target.float())
    if spec.min_snr_gamma is not None:
        w = spec.schedule.min_snr_weight(timesteps, spec.min_snr_gamma)
        per_elem = per_elem * w.float()[:, None, None, None]

    if spec.prior_preservation:
        # collate appends the class items after the instance items
        inst, prior = per_elem.chunk(2, dim=0)
        loss = inst.mean() + spec.prior_loss_weight * prior.mean()
    else:
        loss = per_elem.mean()
    return loss, {"train_loss": loss}


def apply_updates(trainable: Params, updates: Params, step: int) -> Params:
    """Masters + updates, as new tensors; bf16 masters add in fp32 and round
    stochastically."""
    return {k: apply_update_reference(trainable[k], updates[k], step,
                                      leaf_salt(k, MASTER_SALT))
            for k in sorted(trainable)}


def loss_and_grads(spec: StepSpec, trainable: Params, frozen: Params, batch: dict,
                   generator: Optional[torch.Generator], draws: Optional[Draws] = None,
                   compute_copy: Optional[Params] = None, parallel=None
                   ) -> tuple[torch.Tensor, Params]:
    """(loss, gradients) with gradients taken w.r.t. a compute-dtype copy of
    the trainable dict, so they come out in the compute dtype (bf16), as in
    the JAX step. A trainable the loss does not reach (the LoRA factors of a
    CLIP layer that CLIP-skip drops) gets zeros, as ``jax.grad`` gives it.
    ``compute_copy``: that copy, kept (sharded masters: every trainable's,
    where ``trainable`` holds the owned masters only)."""
    dt = spec.compute_dtype
    use_compute = dt != torch.float32
    with tracing.span("train.cast"):
        if compute_copy is not None:
            compute = {k: v.detach().requires_grad_(True) for k, v in compute_copy.items()}
        else:
            compute = {k: (v.detach().to(dt) if use_compute and v.is_floating_point()
                           else v.detach()).requires_grad_(True)
                       for k, v in trainable.items()}
    with tracing.span("train.forward"):
        loss, _ = compute_loss(compute, frozen, batch, generator, spec, draws, parallel)
    keys = list(compute)
    with tracing.span("train.backward"):
        grads = torch.autograd.grad(loss, [compute[k] for k in keys], allow_unused=True)
    return loss.detach(), {k: g if g is not None else torch.zeros_like(compute[k])
                           for k, g in zip(keys, grads)}


def make_train_step(spec: StepSpec, tx, lr_fn: Callable[[int], float],
                    ema_enabled: bool = False, parallel=None):
    """Build ``train_step(state, frozen, batch, draws=None) -> (state, metrics)``:
    ``loss_and_grads``, then ``tx.update_and_apply``, which updates the
    masters of ``state.trainable`` in place, then (``ema_enabled``) the EMA
    of the new masters, its shadows updated in place. ``parallel``: the
    gradients are averaged over the data-parallel ranks (the loss too) before
    the update of the owned masters, whose compute copies are broadcast
    after every update (not after the micro-steps that only accumulate).
    The step is the span ``train.step``, its phases spans under it
    (``utils/tracing.py``)."""
    def step(state: TrainState, frozen: Params, batch: dict, draws: Optional[Draws]):
        loss, grads = loss_and_grads(spec, state.trainable, frozen, batch, state.generator,
                                     draws, state.compute, parallel)
        ema = state.ema
        with torch.no_grad():
            if parallel is not None:
                with tracing.span("train.allreduce"):
                    parallel.reduce_grads(grads)
                    loss = parallel.mean_loss(loss)
                grads = {k: grads[k] for k in state.trainable}
            with tracing.span("train.optimizer"):
                opt_state = tx.update_and_apply(grads, state.opt_state, state.trainable,
                                                state.step)
            del grads
            if ema_enabled:
                if ema is None:
                    raise ValueError("EMA is on but the train state holds none "
                                     "(init_train_state(ema_enabled=True))")
                with tracing.span("train.ema"):
                    ema = ema_update(ema, state.trainable, state.step)
            if state.compute is not None and _updated(opt_state):
                with tracing.span("train.refresh"):
                    parallel.refresh_compute(state.compute, state.trainable)
        metrics = {"train_loss": loss, "lr": lr_fn(state.step)}
        return state._replace(step=state.step + 1, opt_state=opt_state, ema=ema), metrics

    def train_step(state: TrainState, frozen: Params, batch: dict,
                   draws: Optional[Draws] = None):
        with tracing.span("train.step"):
            return step(state, frozen, batch, draws)

    return train_step


def _updated(opt_state) -> bool:
    """Whether the step's ``update_and_apply`` changed the masters: always,
    but under gradient accumulation only at the emit (its count back at 0)."""
    return not isinstance(opt_state, AccumulationState) or opt_state.mini == 0


def init_train_state(trainable: Params, tx, seed: int = 0, ema_enabled: bool = False,
                     ema_decay: float = 0.995,
                     ema_dtype: torch.dtype = torch.float32,
                     compute: Optional[Params] = None,
                     device: Optional[torch.device] = None) -> TrainState:
    """Step 0, optimizer state, a generator seeded on the params' device, and
    (``ema_enabled``) an EMA shadow of the ``unet.*`` masters in
    ``ema_dtype``. Sharded masters: ``trainable`` holds the rank's own (it
    may hold none), ``compute`` every trainable's compute-dtype copy, and
    ``device`` names the device."""
    if device is None:
        device = next(iter(trainable.values())).device
    ema = None
    if ema_enabled:
        ema = ema_init({k: v for k, v in trainable.items() if k.startswith(UNET_PREFIX + ".")},
                       ema_decay, ema_dtype)
    return TrainState(step=0, trainable=trainable, opt_state=tx.init(trainable),
                      generator=torch.Generator(device=device).manual_seed(seed), ema=ema,
                      compute=compute)
