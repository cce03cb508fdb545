"""Functional NN primitives over flat parameter dicts (port of
``scal_sdt_tpu/models/functional.py``).

Parameters are one flat ``{dotted.name: tensor}`` dict keyed by diffusers
names in torch layouts; activations are NCHW here (the JAX package is NHWC).
Precision follows the JAX code, not ``torch.autocast``: linear and conv
outputs stay in the activation dtype, GroupNorm and LayerNorm take fp32
statistics and cast back.

LoRA factors (``{name}.lora_A``) are a later slice of the port: a parameter
dict holding them is refused rather than silently run without the delta.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Params = dict[str, torch.Tensor]


def _no_lora(p: Params, name: str) -> None:
    if f"{name}.lora_A" in p:
        raise NotImplementedError(
            f"LoRA factors on {name}: the port does not run LoRA yet")


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T + b with W stored (out, in)."""
    _no_lora(p, name)
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def conv2d(p: Params, name: str, x: torch.Tensor, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """NCHW convolution with an OIHW kernel."""
    _no_lora(p, name)
    return F.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"),
                    stride=stride, padding=padding)


def group_norm(p: Params, name: str, x: torch.Tensor, groups: int = 32,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NCHW; statistics and affine in fp32."""
    y = F.group_norm(x.float(), groups, p[f"{name}.weight"].float(),
                     p[f"{name}.bias"].float(), eps)
    return y.to(x.dtype)


def layer_norm(p: Params, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    y = F.layer_norm(x.float(), x.shape[-1:], p[f"{name}.weight"].float(),
                     p[f"{name}.bias"].float(), eps)
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: int = 10000,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(float(max_period)) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)
