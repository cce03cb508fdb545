"""LoRA factor parameters for flat param dicts (port of
``scal_sdt_tpu/training/lora.py``).

Instead of swapping Linear/Conv2d modules (the original trainer's loralib
wrapping), the factors are extra keys of the same flat dict:
``{path}.lora_A`` (r, in), ``{path}.lora_B`` (out, r) and an int32
``{path}.lora_alpha``, which ``models/functional.py`` adds as a delta. The
checkpoint names are loralib's, so the kohya/AddNet export stays the same.
Targets are Linear and 1x1 Conv weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .optim_targets import LoRASpec

Params = dict[str, torch.Tensor]


def lora_factor_shapes(base_params: Params, lora_specs: dict[str, LoRASpec]
                       ) -> dict[str, tuple[int, ...]]:
    shapes = {}
    for path, spec in lora_specs.items():
        w = base_params[f"{path}.weight"]
        if w.ndim == 2:
            out_f, in_f = w.shape
        elif w.ndim == 4 and w.shape[2] == 1 and w.shape[3] == 1:
            out_f, in_f = w.shape[0], w.shape[1]
        else:
            raise ValueError(f"LoRA target {path} must be Linear or 1x1 Conv, got shape "
                             f"{tuple(w.shape)}")
        shapes[f"{path}.lora_A"] = (spec.rank, int(in_f))
        shapes[f"{path}.lora_B"] = (int(out_f), spec.rank)
    return shapes


def init_lora_params(generator: torch.Generator, base_params: Params,
                     lora_specs: dict[str, LoRASpec], dtype: torch.dtype = torch.float32,
                     device="cpu") -> Params:
    """A ~ N(0, 1) / sqrt(in) drawn from ``generator`` path by path in sorted
    order, B = 0 (so the delta starts at zero), and the alpha as
    ``int32(int(alpha))``: truncated, as the JAX package stores it."""
    out: Params = {}
    shapes = lora_factor_shapes(base_params, lora_specs)
    for path in sorted(lora_specs):
        a_shape = shapes[f"{path}.lora_A"]
        a = torch.randn(a_shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        out[f"{path}.lora_A"] = (a * np.float32(1.0 / math.sqrt(a_shape[1]))).to(device, dtype)
        out[f"{path}.lora_B"] = torch.zeros(shapes[f"{path}.lora_B"], dtype=dtype, device=device)
        out[f"{path}.lora_alpha"] = torch.tensor(int(lora_specs[path].alpha), dtype=torch.int32,
                                                 device=device)
    return out


@torch.no_grad()
def merge_lora_into_base(base_params: Params, prefix_filter: str = "") -> Params:
    """Fold the LoRA factors into the base weights, ``W' = W + (alpha / r) B A``
    in fp32, cast back to W's dtype; the factor keys are dropped."""
    out = dict(base_params)
    for k in list(base_params):
        if not k.endswith(".lora_A"):
            continue
        path = k[: -len(".lora_A")]
        if prefix_filter and not path.startswith(prefix_filter):
            continue
        a = base_params[k].float()
        b = base_params[f"{path}.lora_B"].float()
        alpha = base_params.get(f"{path}.lora_alpha")
        alpha = float(alpha) if alpha is not None else float(a.shape[0])
        w = base_params[f"{path}.weight"]
        delta = (alpha / a.shape[0]) * (b @ a)
        if w.ndim == 4:
            delta = delta[:, :, None, None]
        out[f"{path}.weight"] = (w.float() + delta).to(w.dtype)
        for suffix in (".lora_A", ".lora_B", ".lora_alpha"):
            out.pop(path + suffix, None)
    return out
