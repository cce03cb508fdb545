"""The training step (port of ``scal_sdt_tpu/training/step.py``, cached
branch).

``compute_loss`` is the cached-latent body: q-sample (with the optional noise
offset and multires noise), UNet, MSE against the schedule target in fp32,
optional min-SNR weighting and prior preservation. ``make_train_step`` takes
gradients with respect to a compute-dtype copy of the trainable dict (bf16
gradients, as in the JAX step), runs the optimizer, and applies the update to
the masters; bf16 masters take the fp32 add and a stochastically rounded
store salted ``crc32(key) ^ 0xE3A0001``, bit for bit the JAX dither.

The JAX step draws noise and timesteps from ``fold_in(rng, step)``; torch
cannot reproduce that stream, so the port draws from an explicit
``torch.Generator`` and accepts the draws from the caller instead
(``Draws``), which is how the tests feed both the same numbers. The uncached
(VAE/CLIP), SDXL and SD3 branches and the EMA are later slices.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..conf import Config
from ..diffusion.schedule import NoiseSchedule
from ..models.functional import Params
from ..models.unet import UNetConfig, unet_apply
from ..ops.sr import stochastic_round_bf16_cheap
from .optim_targets import COMPONENT_PREFIX

UNET_PREFIX = COMPONENT_PREFIX["unet"]
_MASTER_SALT = 0xE3A0001


class TrainState(NamedTuple):
    step: int                     # host-side step count
    trainable: Params             # prefixed flat dict (masters)
    opt_state: object
    generator: torch.Generator    # draws noise and timesteps, on the params' device


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """Static configuration of the step."""
    unet_config: UNetConfig
    schedule: NoiseSchedule
    compute_dtype: torch.dtype
    remat: object = False     # False | True | 'high' | 'top' (see unet_apply)
    prior_preservation: bool = False
    prior_loss_weight: float = 1.0
    min_snr_gamma: Optional[float] = None
    noise_offset: float = 0.0
    multires_noise_iterations: int = 0
    multires_noise_discount: float = 0.25

    @classmethod
    def from_config(cls, config: Config, unet_config: UNetConfig,
                    schedule: Optional[NoiseSchedule] = None) -> "StepSpec":
        precision = config.trainer.get("precision", "bf16")
        loss = config.get("loss") or {}
        gc = config.get("gradient_checkpointing", False)
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
        )


@dataclasses.dataclass
class Draws:
    """The random numbers of one ``compute_loss`` call (NCHW)."""
    noise: torch.Tensor                      # (B, C, h, w)
    timesteps: torch.Tensor                  # (B,) integer
    offset: Optional[torch.Tensor] = None    # (B, C, 1, 1), with noise_offset
    octaves: tuple[torch.Tensor, ...] = ()   # multires octaves, coarsest last


def _octave_sizes(h: int, w: int, iterations: int) -> list[tuple[int, int]]:
    sizes = []
    for i in range(1, iterations + 1):
        hi, wi = max(1, h // (2 ** i)), max(1, w // (2 ** i))
        sizes.append((hi, wi))
        if hi == 1 and wi == 1:
            break
    return sizes


def draw(generator: torch.Generator, spec: StepSpec, latents: torch.Tensor) -> Draws:
    """Fresh draws for one step from ``generator``."""
    b, c, h, w = latents.shape
    dt, dev = spec.compute_dtype, latents.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dt, device=dev)

    return Draws(
        noise=normal(b, c, h, w),
        timesteps=spec.schedule.sample_timesteps(generator, b, dev),
        offset=normal(b, c, 1, 1) if spec.noise_offset else None,
        octaves=tuple(normal(b, c, hi, wi) for hi, wi in
                      _octave_sizes(h, w, spec.multires_noise_iterations)),
    )


def _scaled(x: torch.Tensor, s: float) -> torch.Tensor:
    """x * s with the python scalar rounded to x's dtype first, as JAX does."""
    return x * x.new_full((), s)


def _multires_noise(noise: torch.Tensor, octaves, discount: float) -> torch.Tensor:
    """Pyramid noise: bilinearly upsampled octaves weighted discount^i, then
    each sample renormalised to unit std (population std, fp32)."""
    total = noise
    for i, octave in enumerate(octaves, start=1):
        up = F.interpolate(octave, size=noise.shape[2:], mode="bilinear", align_corners=False)
        total = total + _scaled(up, discount ** i)
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


def compute_loss(trainable: Params, frozen: Params, batch: dict,
                 generator: Optional[torch.Generator], spec: StepSpec,
                 draws: Optional[Draws] = None) -> tuple[torch.Tensor, dict]:
    """The training loss on a cached batch.

    batch: 'latents' (B, 4, h, w) pre-scaled, 'conds' (B, L, D). ``draws``
    replaces the generator's draws when given."""
    if "latents" not in batch or "conds" not in batch:
        raise NotImplementedError(
            "the port trains on cached latents and conds only so far "
            "(batch needs 'latents' and 'conds')")
    dt = spec.compute_dtype
    latents = batch["latents"].to(dt)
    conds = batch["conds"].to(dt)
    if draws is None:
        draws = draw(generator, spec, latents)

    noise = draws.noise.to(dt)
    if spec.noise_offset:
        noise = noise + _scaled(draws.offset.to(dt), spec.noise_offset)
    if spec.multires_noise_iterations > 0:
        noise = _multires_noise(noise, [o.to(dt) for o in draws.octaves],
                                spec.multires_noise_discount)
    timesteps = draws.timesteps
    noisy = spec.schedule.add_noise(latents, noise, timesteps)

    unet_params = _merged_component(trainable, frozen, UNET_PREFIX, dt)
    pred = unet_apply(unet_params, noisy, timesteps, conds, spec.unet_config, remat=spec.remat)

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
    """Masters + updates; bf16 masters add in fp32 and round stochastically."""
    new = {}
    for k in sorted(trainable):
        p, u = trainable[k], updates[k]
        if p.dtype == torch.bfloat16:
            new[k] = stochastic_round_bf16_cheap(p.float() + u.float(), step,
                                                 zlib.crc32(k.encode()) ^ _MASTER_SALT)
        else:
            new[k] = p + u.to(p.dtype)
    return new


def loss_and_grads(spec: StepSpec, trainable: Params, frozen: Params, batch: dict,
                   generator: Optional[torch.Generator], draws: Optional[Draws] = None
                   ) -> tuple[torch.Tensor, Params]:
    """(loss, gradients) with gradients taken w.r.t. a compute-dtype copy of
    the trainable dict, so they come out in the compute dtype (bf16), as in
    the JAX step."""
    dt = spec.compute_dtype
    use_compute = dt != torch.float32
    compute = {k: (v.detach().to(dt) if use_compute and v.is_floating_point()
                   else v.detach()).requires_grad_(True)
               for k, v in trainable.items()}
    loss, _ = compute_loss(compute, frozen, batch, generator, spec, draws)
    keys = list(compute)
    grads = torch.autograd.grad(loss, [compute[k] for k in keys])
    return loss.detach(), dict(zip(keys, grads))


def make_train_step(spec: StepSpec, tx, lr_fn: Callable[[int], float],
                    ema_enabled: bool = False):
    """Build ``train_step(state, frozen, batch, draws=None) -> (state, metrics)``:
    ``loss_and_grads``, then ``tx.update``, then ``apply_updates``."""
    if ema_enabled:
        raise NotImplementedError("EMA: the port does not run ema_update yet")

    def train_step(state: TrainState, frozen: Params, batch: dict,
                   draws: Optional[Draws] = None):
        loss, grads = loss_and_grads(spec, state.trainable, frozen, batch, state.generator,
                                     draws)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state, state.trainable)
            del grads
            trainable = apply_updates(state.trainable, updates, state.step)
        metrics = {"train_loss": loss, "lr": lr_fn(state.step)}
        return TrainState(state.step + 1, trainable, opt_state, state.generator), metrics

    return train_step


def init_train_state(trainable: Params, tx, seed: int = 0,
                     ema_enabled: bool = False) -> TrainState:
    """Step 0, optimizer state, and a generator seeded on the params' device."""
    if ema_enabled:
        raise NotImplementedError("EMA: the port does not run ema_update yet")
    device = next(iter(trainable.values())).device
    return TrainState(step=0, trainable=trainable, opt_state=tx.init(trainable),
                      generator=torch.Generator(device=device).manual_seed(seed))
