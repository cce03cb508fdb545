"""Rectified-flow (flow-matching) schedule of the SD3 family (port of
``scal_sdt_tpu/diffusion/flow.py``).

diffusers' FlowMatchEulerDiscreteScheduler plus SD3's training-time timestep
density (arXiv:2403.03206 §3.1): the forward process is the straight line
``x_t = (1 - sigma) x0 + sigma eps``, the training target the constant
velocity ``eps - x0``, sigmas carry the resolution shift ``sigma = shift u /
(1 + (shift - 1) u)``, and training timesteps are drawn logit-normally
(``u = sigmoid(N(mean, std))``).

Its timesteps are floats: the model timestep ``sigma * N`` in [0, N], where
``NoiseSchedule`` draws integers. The training step calls the same methods
on either schedule (``sample_timesteps``, ``add_noise``,
``training_target``, ``num_train_timesteps``, ``prediction_type``) and never
branches on the class. Min-SNR weighting is a DDPM weighting and is refused.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FlowSchedule:
    num_train_timesteps: int = 1000
    # resolution shift (3.0 = SD3-Medium / SD3.5 default)
    shift: float = 3.0
    # logit-normal training density (the paper's lognorm(0.00, 1.00))
    logit_mean: float = 0.0
    logit_std: float = 1.0
    prediction_type: str = "flow"

    def shifted_sigma(self, u: torch.Tensor) -> torch.Tensor:
        """u in [0, 1] -> shifted sigma in [0, 1]."""
        return self.shift * u / (1.0 + (self.shift - 1.0) * u)

    def sigma_of_t(self, t: torch.Tensor) -> torch.Tensor:
        """Model-facing timestep (sigma * N, float) -> sigma, fp32."""
        return t.float() / self.num_train_timesteps

    def timesteps_of(self, z: torch.Tensor) -> torch.Tensor:
        """FLOAT model timesteps ``sigma * N`` of standard normal draws ``z``."""
        u = torch.sigmoid(self.logit_mean + self.logit_std * z.float())
        return self.shifted_sigma(u) * self.num_train_timesteps

    def sample_timesteps(self, generator: torch.Generator, bsz: int,
                         device: torch.device) -> torch.Tensor:
        """Logit-normal draw: (bsz,) fp32 model timesteps."""
        z = torch.randn((bsz,), generator=generator, dtype=torch.float32, device=device)
        return self.timesteps_of(z)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        sigma = self.sigma_of_t(t).to(x0.dtype)
        sigma = sigma.reshape(sigma.shape + (1,) * (x0.dim() - 1))
        return (1.0 - sigma) * x0 + sigma * noise

    def training_target(self, x0: torch.Tensor, noise: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        # d x_t / d sigma: constant along the straight path
        return noise - x0

    def sampling_sigmas(self, num_steps: int) -> torch.Tensor:
        """Inference sigma ladder, high -> low, with the terminal 0 appended
        (diffusers FlowMatchEulerDiscreteScheduler.set_timesteps), fp32."""
        u = torch.linspace(1.0, 1.0 / self.num_train_timesteps, num_steps)
        return torch.cat([self.shifted_sigma(u), torch.zeros(1)])

    def min_snr_weight(self, t: torch.Tensor, gamma: float) -> torch.Tensor:
        raise NotImplementedError(
            "min_snr_gamma is a DDPM weighting; the flow schedule's logit-normal "
            "timestep density is the SD3 equivalent (remove loss.min_snr_gamma from the "
            "config)")

    @classmethod
    def from_diffusers_scheduler_config(cls, config: dict) -> "FlowSchedule":
        return cls(num_train_timesteps=int(config.get("num_train_timesteps", 1000)),
                   shift=float(config.get("shift", 3.0)))
