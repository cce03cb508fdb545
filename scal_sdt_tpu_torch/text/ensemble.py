"""Ensemble text encoding (port of ``scal_sdt_tpu/text/ensemble.py``; the
reference's EnsembleTextEncoder + clip_t5_encoder, experimental there too).

Concatenates the sequence outputs of several encoders along the token axis,
optionally projecting each to a common width first. Functional: an encoder is
(params, apply_fn, tokenizer); the ensemble tokenizes per encoder and
concatenates hidden states. The reference's CLIP + T5 combination maps onto
two entries; any encoder with the same (B, L_i, D) output contract works.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..models.functional import Params, layer_norm, linear


@dataclasses.dataclass
class EncoderEntry:
    params: Params
    apply_fn: Callable[[Params, torch.Tensor], torch.Tensor]  # (params, ids) -> (B, L, D)
    tokenizer: Callable
    # optional projection to the common width: '<prefix>.0.weight' (a bias-free
    # linear) and '<prefix>.1.weight' / '.bias' (a layer norm) in params
    projection_prefix: Optional[str] = None


def encode_ensemble(entries: Sequence[EncoderEntry], prompts: list[str]) -> torch.Tensor:
    """-> (B, sum L_i, D) conditioning. Each entry's ids go to the device of
    its params."""
    outs = []
    for e in entries:
        device = next(iter(e.params.values())).device
        ids = torch.as_tensor(e.tokenizer(prompts), device=device)
        z = e.apply_fn(e.params, ids)
        if e.projection_prefix is not None:
            z = linear(e.params, f"{e.projection_prefix}.0", z)
            z = layer_norm(e.params, f"{e.projection_prefix}.1", z)
        outs.append(z)
    dims = {int(z.shape[-1]) for z in outs}
    if len(dims) != 1:
        raise ValueError(f"ensemble members disagree on width: {sorted(dims)}")
    return torch.cat(outs, dim=1)
