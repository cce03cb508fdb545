"""DDPM noise schedule: q-sample and training targets (port of
``scal_sdt_tpu/diffusion/schedule.py``).

The tables are computed on the host in float64/float32 exactly as the JAX
version does, then kept per (device, dtype) so a training step gathers from
a device tensor without a host copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Stable Diffusion v1's scaled-linear DDPM schedule by default
    (beta in [0.00085, 0.012] over 1000 steps)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"  # 'epsilon' | 'sample' | 'v'
    # Zero-terminal-SNR beta rescale (arXiv:2305.08891): the last train
    # timestep becomes pure noise. Requires v or sample prediction.
    rescale_zero_terminal_snr: bool = False
    _tables: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                      compare=False, hash=False)

    def __post_init__(self):
        if self.prediction_type == "v_prediction":
            object.__setattr__(self, "prediction_type", "v")
        if self.rescale_zero_terminal_snr and self.prediction_type == "epsilon":
            raise ValueError(
                "rescale_zero_terminal_snr requires v (or sample) prediction: "
                "at terminal SNR 0 the epsilon target carries no signal "
                "(arXiv:2305.08891 §4)")

    @property
    def betas(self) -> np.ndarray:
        n = self.num_train_timesteps
        if self.beta_schedule == "scaled_linear":
            return np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5, n,
                               dtype=np.float64) ** 2
        if self.beta_schedule == "linear":
            return np.linspace(self.beta_start, self.beta_end, n, dtype=np.float64)
        raise ValueError(self.beta_schedule)

    @property
    def alphas_cumprod(self) -> np.ndarray:
        acp = np.cumprod(1.0 - self.betas)
        if self.rescale_zero_terminal_snr:
            s = np.sqrt(acp)
            s = (s - s[-1]) * (s[0] / (s[0] - s[-1]))
            acp = np.square(s)
        return acp.astype(np.float32)

    def _table(self, name: str, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        key = (name, str(device), dtype)
        if key not in self._tables:
            acp = self.alphas_cumprod
            host = {"acp": acp, "sqrt_acp": np.sqrt(acp),
                    "sqrt_1m_acp": np.sqrt(1.0 - acp)}[name]
            self._tables[key] = torch.from_numpy(host).to(device=device, dtype=dtype)
        return self._tables[key]

    def _gather(self, name: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        v = self._table(name, like.device, like.dtype)[t]
        return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))

    def sample_timesteps(self, generator: torch.Generator, bsz: int,
                         device: torch.device) -> torch.Tensor:
        """Uniform integer draw over [0, N)."""
        return torch.randint(0, self.num_train_timesteps, (bsz,), generator=generator,
                             device=device)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0): sqrt(acp_t) * x0 + sqrt(1 - acp_t) * noise."""
        return (self._gather("sqrt_acp", t, x0) * x0
                + self._gather("sqrt_1m_acp", t, x0) * noise)

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """v-prediction target: sqrt(acp_t) * eps - sqrt(1 - acp_t) * x0."""
        return (self._gather("sqrt_acp", t, x0) * noise
                - self._gather("sqrt_1m_acp", t, x0) * x0)

    def training_target(self, x0: torch.Tensor, noise: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "sample":
            return x0
        if self.prediction_type == "v":
            return self.velocity(x0, noise, t)
        raise ValueError(f"Unknown prediction type {self.prediction_type}")

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        """acp_t / (1 - acp_t), fp32."""
        acp = self._table("acp", t.device, torch.float32)[t]
        return acp / (1.0 - acp)

    def min_snr_weight(self, t: torch.Tensor, gamma: float) -> torch.Tensor:
        """Per-sample Min-SNR-gamma loss weight (arXiv:2303.09556)."""
        snr = self.snr(t)
        clipped = torch.clamp(snr, max=gamma)
        if self.prediction_type == "epsilon":
            return clipped / snr
        if self.prediction_type == "v":
            return clipped / (snr + 1.0)
        return clipped
