"""Plain references of the training objectives, DDIM sampling with
classifier-free guidance, and AdamW, float32.

Objectives (the configuration's ``scheduler`` group): DDPM with the
"scaled_linear" betas (``beta_start``, ``beta_end``, ``num_train_timesteps``)
and the epsilon target; rectified flow (``FlowMatchEulerDiscreteScheduler``,
arXiv:2403.03206 §2): x_t = (1 - sigma) x0 + sigma eps with sigma = t / N,
the target eps - x0. The loss is the mean squared error over every element
of the batch.

DDIM (diffusers' ``DDIMScheduler``, eta 0, "leading" spacing with
``steps_offset``, ``set_alpha_to_one`` false): the unconditional and the
conditional prediction of one call combined as u + s (c - u), x0 and eps
from it, x moved to the previous timestep of the ladder.

AdamW (decoupled weight decay, optax's eps outside the square root): per
leaf, float32 moments; a bfloat16 master takes the float32 sum rounded
stochastically (uniform random low bits from a generator of its own), as the
configuration states for such masters.
"""

from __future__ import annotations

import numpy as np
import torch


def ddpm_alphas_cumprod(sched: dict) -> np.ndarray:
    n = sched["num_train_timesteps"]
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def noisy_and_target(sched: dict, x0: torch.Tensor, noise: torch.Tensor,
                     t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_t, the training target) of clean latents, noise and timesteps."""
    shape = (-1,) + (1,) * (x0.dim() - 1)
    if sched["kind"] == "flow":
        sigma = (t.float() / sched["num_train_timesteps"]).reshape(shape)
        return (1.0 - sigma) * x0 + sigma * noise, noise - x0
    acp = torch.from_numpy(ddpm_alphas_cumprod(sched)).to(x0.device)[t].reshape(shape)
    return acp.sqrt() * x0 + (1.0 - acp).sqrt() * noise, noise


def ddim_timesteps(sched: dict, steps: int) -> list[int]:
    ratio = sched["num_train_timesteps"] // steps
    return [int(t) + sched["steps_offset"] for t in (np.arange(steps) * ratio)[::-1]]


def ddim_sample(denoise, x: torch.Tensor, sched: dict, steps: int,
                cfg_scale: float) -> torch.Tensor:
    """``denoise(x_pair, t) -> (uncond, cond)`` predictions; ``x`` the
    initial noise. Returns the final latents."""
    acp = torch.from_numpy(ddpm_alphas_cumprod(sched)).to(x.device)
    step = sched["num_train_timesteps"] // steps
    for t in ddim_timesteps(sched, steps):
        u, c = denoise(x, t)
        eps = u + cfg_scale * (c - u)
        x0 = (x - (1.0 - acp[t]).sqrt() * eps) / acp[t].sqrt()
        prev = acp[t - step] if t - step >= 0 else acp[0]
        x = prev.sqrt() * x0 + (1.0 - prev).sqrt() * eps
    return x


class AdamW:
    """optax-style AdamW over a dict of float32 tensors (masters in
    ``master_dtype``: float32, or bfloat16 rounded stochastically)."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float, weight_decay: float,
                 master_dtype: torch.dtype, seed: int, device):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        self.master_dtype = master_dtype
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.mu: dict[str, torch.Tensor] = {}
        self.nu: dict[str, torch.Tensor] = {}
        self.count = 0

    def _store(self, x: torch.Tensor) -> torch.Tensor:
        if self.master_dtype == torch.float32:
            return x
        bits = x.contiguous().view(torch.int32)
        noise = torch.randint(0, 1 << 16, x.shape, generator=self.gen, device=x.device,
                              dtype=torch.int32)
        rounded = ((bits + noise) & ~0xFFFF).view(torch.float32)
        return rounded.to(torch.bfloat16).float()

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, g in grads.items():
            mu = self.mu.setdefault(k, torch.zeros_like(g))
            nu = self.nu.setdefault(k, torch.zeros_like(g))
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p = params[k]
            u = (mu / c1) / ((nu / c2).sqrt() + self.eps) + self.wd * p
            p.copy_(self._store(p - self.lr * u))
