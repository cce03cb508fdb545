"""Functional NN primitives over flat parameter dicts (port of
``scal_sdt_tpu/models/functional.py``).

Parameters are one flat ``{dotted.name: tensor}`` dict keyed by diffusers
names in torch layouts; activations are NCHW here (the JAX package is NHWC).
Precision follows the JAX code, not ``torch.autocast``: linear and conv
outputs stay in the activation dtype, GroupNorm and LayerNorm take fp32
statistics and cast back.

LoRA factors ride in the same dict as ``{name}.lora_A`` (r, in),
``{name}.lora_B`` (out, r) and an integer ``{name}.lora_alpha``: ``linear``
and 1x1 ``conv2d`` add ``(x A^T) B^T * alpha / r`` (over the channel axis,
dim 1, for the NCHW conv). LoRA dropout (the original trainer's
``lora_dropout``) drops the delta's input with a static per-path rate
(``set_lora_dropout_rates``) on the training path only: the train step puts
a ``LoRADropout`` under ``LORA_DROPOUT`` in the component's dict, inference
never does. Under tensor parallelism (``parallel/tensor.py``) the dict also
holds a ``TENSOR_PARALLEL`` entry, and ``linear`` runs a split layer as its
column- or row-parallel half.
"""

from __future__ import annotations

import math
import zlib
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel.tensor import TENSOR_PARALLEL

Params = dict[str, torch.Tensor]


# --- LoRA dropout -------------------------------------------------------------
LORA_DROPOUT = "__lora_dropout__"
_LORA_DROPOUT_RATES: dict[str, float] = {}
_SEED_MASK = (1 << 63) - 1


def set_lora_dropout_rates(rates: dict[str, float]) -> None:
    """Replace the static path -> rate registry (component-relative paths)."""
    _LORA_DROPOUT_RATES.clear()
    _LORA_DROPOUT_RATES.update({k: float(v) for k, v in rates.items() if v})


def lora_dropout_rates() -> dict[str, float]:
    return dict(_LORA_DROPOUT_RATES)


def layer_seed(base: int, name: str) -> int:
    """The seed of layer ``name``'s mask generator in a step with base seed
    ``base`` (the analogue of JAX's ``fold_in(rng, crc32(name))``)."""
    return (int(base) * 0x9E3779B97F4A7C15 + zlib.crc32(name.encode())) & _SEED_MASK


class LoRADropout:
    """The keep masks of one step: each layer draws its own from a generator
    seeded by ``layer_seed(base, name)``, so a recompute under
    ``torch.utils.checkpoint`` (which restores the global RNG state, not an
    explicit generator's) draws the same mask again; or ``masks`` (layer
    name -> bool keep mask in the layer input's layout) replace the draws."""

    def __init__(self, base: Optional[int] = None,
                 masks: Optional[dict[str, torch.Tensor]] = None):
        self.base, self.masks = base, masks

    def keep(self, name: str, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.masks is not None:
            return self.masks[name].to(x.device)
        gen = torch.Generator(device=x.device).manual_seed(layer_seed(self.base, name))
        return torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate


def _lora_delta(p: Params, name: str, x: torch.Tensor, y: torch.Tensor,
                conv: bool = False) -> torch.Tensor:
    """y plus the LoRA update ``(x A^T) B^T * alpha / r`` if ``{name}.lora_A``
    is in ``p``. Both products come out in x's dtype; the scale is
    ``alpha / r`` in y's dtype (a division by a 0-dim tensor: torch on CUDA
    would multiply by the reciprocal of a python divisor). ``conv``: x is
    NCHW and the product runs over its channel axis."""
    a = p.get(f"{name}.lora_A")
    if a is None:
        return y
    rate = _LORA_DROPOUT_RATES.get(name, 0.0)
    dropout = p.get(LORA_DROPOUT)
    if rate > 0.0 and dropout is not None:
        keep = dropout.keep(name, x, rate)
        if keep.shape[-1] != x.shape[-1]:
            # a given mask over a row-parallel layer's whole input: the rank's columns
            n, i = x.shape[-1], p[TENSOR_PARALLEL].index
            keep = keep[..., i * n:(i + 1) * n]
        x = torch.where(keep, x / x.new_full((), 1.0 - rate), x.new_zeros(()))
    b = p[f"{name}.lora_B"]
    alpha = p.get(f"{name}.lora_alpha")
    rank = a.shape[0]
    scale = (alpha.to(y.dtype) if alpha is not None else y.new_ones(())) / y.new_full((), rank)
    a, b = a.to(x.dtype), b.to(x.dtype)
    if conv:
        h = F.conv2d(F.conv2d(x, a[:, :, None, None]), b[:, :, None, None])
    else:
        h = F.linear(F.linear(x, a), b)
    return y + h * scale


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T + b with W stored (out, in), plus its LoRA delta. A
    tensor-split layer takes its input through ``copy_in`` (column) or sums
    its partial output over the tensor group and then adds the bias (row)."""
    tp = p.get(TENSOR_PARALLEL)
    kind = tp.kind(name) if tp is not None else None
    if kind == "row":
        y = _lora_delta(p, name, x, F.linear(x, p[f"{name}.weight"]))
        total = tp.reduce_out(y)
        b = p.get(f"{name}.bias")
        return (total + b.float() if b is not None else total).to(y.dtype)
    if kind == "col":
        x = tp.copy_in(x)
    y = F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))
    return _lora_delta(p, name, x, y)


def conv2d(p: Params, name: str, x: torch.Tensor, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """NCHW convolution with an OIHW kernel; a 1x1 kernel takes its LoRA
    delta."""
    w = p[f"{name}.weight"]
    y = F.conv2d(x, w, p.get(f"{name}.bias"), stride=stride, padding=padding)
    if w.shape[2] == 1 and w.shape[3] == 1 and f"{name}.lora_A" in p:
        y = _lora_delta(p, name, x, y, conv=True)
    return y


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


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(scaled(x, 1.702))


def scaled(x: torch.Tensor, s: float) -> torch.Tensor:
    """x * s with the python scalar rounded to x's dtype first, as JAX does
    (weak-typed python scalars take the array's dtype)."""
    return x * x.new_full((), s)


def sub_params(p: Params, prefix: str) -> Params:
    """View of a flat param dict under ``prefix.`` with the prefix stripped."""
    cut = len(prefix) + 1
    return {k[cut:]: v for k, v in p.items() if k.startswith(prefix + ".")}


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


def init_params(shapes: dict[str, tuple[int, ...]], seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random init of a shape template (fan-in scaled normal weights, unit
    norm scales, zero biases) from a seeded ``torch.Generator`` on
    ``device``; real runs load pretrained weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Params = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(".bias"):
            params[name] = torch.zeros(shape, dtype=dtype, device=dev)
        elif len(shape) == 1:
            params[name] = torch.ones(shape, dtype=dtype, device=dev)
        else:
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
            params[name] = (w / math.sqrt(max(math.prod(shape[1:]), 1))).to(dtype)
    return params
