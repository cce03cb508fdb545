"""Parameter-name helpers for Stable Diffusion checkpoints (the part of
``scal_sdt_tpu/convert/sd_names.py`` the diffusers loader needs).

The LDM <-> diffusers and OpenCLIP <-> transformers name maps come with the
single-file loaders and the checkpoint tools.
"""

from __future__ import annotations

import torch

_VAE_ATTENTION_RENAMES = {
    ".query.": ".to_q.", ".key.": ".to_k.", ".value.": ".to_v.",
    ".proj_attn.": ".to_out.0.",
}


def normalize_df_vae_attention(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Normalize legacy diffusers VAE attention names (query/key/value/
    proj_attn) to the modern to_q/to_k/to_v/to_out.0 used internally; 1x1
    conv weights of those projections become linear (out, in) weights."""
    out = {}
    for k, v in state.items():
        for old, new in _VAE_ATTENTION_RENAMES.items():
            if old in k and "attentions" in k:
                k = k.replace(old, new)
                if k.endswith(".weight") and v.dim() > 2:
                    v = v.reshape(v.shape[0], v.shape[1])
                break
        out[k] = v
    return out
