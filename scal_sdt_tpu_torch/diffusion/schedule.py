"""DDPM noise schedule: q-sample, training targets and the DDIM sampling
fields (port of ``scal_sdt_tpu/diffusion/schedule.py``).

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
    # DDIM sampling semantics (diffusers SD1 scheduler config)
    steps_offset: int = 1
    clip_sample: bool = False
    set_alpha_to_one: bool = False
    # diffusers timestep_spacing: 'leading' (SD default) or 'trailing'
    # (recommended with zero-terminal-SNR models, arXiv:2305.08891 §3.2:
    # sampling then starts from the pure-noise timestep T-1)
    timestep_spacing: str = "leading"
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

    @classmethod
    def from_ldm_config(cls, ldm_config, **overrides) -> "NoiseSchedule":
        """The betas of a CompVis LDM architecture YAML (``parameterization``
        is not read, as in the JAX package)."""
        params = ldm_config.model.params
        return cls(
            num_train_timesteps=int(params.get("timesteps", 1000)),
            beta_start=float(params.get("linear_start", 0.00085)),
            beta_end=float(params.get("linear_end", 0.012)),
            **overrides,
        )

    @classmethod
    def from_diffusers_scheduler_config(cls, config: dict) -> "NoiseSchedule":
        """The fields of a diffusers ``scheduler_config.json``."""
        return cls(
            num_train_timesteps=int(config.get("num_train_timesteps", 1000)),
            beta_start=float(config.get("beta_start", 0.00085)),
            beta_end=float(config.get("beta_end", 0.012)),
            beta_schedule=config.get("beta_schedule", "scaled_linear"),
            prediction_type=config.get("prediction_type", "epsilon"),
            steps_offset=int(config.get("steps_offset", 1)),
            clip_sample=bool(config.get("clip_sample", False)),
            set_alpha_to_one=bool(config.get("set_alpha_to_one", False)),
            rescale_zero_terminal_snr=bool(config.get("rescale_betas_zero_snr", False)),
            timestep_spacing=config.get("timestep_spacing", "leading"),
        )

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
