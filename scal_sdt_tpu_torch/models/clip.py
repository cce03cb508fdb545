"""CLIP text encoders (ViT-L/14, and SDXL's OpenCLIP bigG tower) over a flat
param dict (port of ``scal_sdt_tpu/models/clip.py``).

Equivalent of ``transformers.CLIPTextModel`` as the reference's
``CLIPTextEncoder`` uses it. CLIP-skip is the call-time ``stop_at_layer``
argument: the last ``stop_at_layer - 1`` transformer layers are dropped and
the final layer norm still applies (SD1.x fine-tunes commonly condition on
the penultimate layer, ``clip_stop_at_layer: 2``).

Parameter keys are the transformers state-dict names under ``text_model.``.
The causal self-attention goes through ``ops/attention.py`` and takes its
math path (causal, L = 77), as it takes XLA's on the TPU. Textual-inversion
rows trained beside the frozen table (``token_embedding.trained_extra``,
``text/ti.py``) are appended below it, so only they take gradients.
``clip_text_encode_sdxl`` is SDXL's encode: the raw penultimate hidden state
and, for a tower with a projection head (``text_projection.weight``), the
pooled projected embedding at the first EOS; ``encode_sdxl`` is SDXL's
conditioning through both towers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.attention import multi_head_attention
from .functional import Params, gelu, init_params, layer_norm, linear, quick_gelu

TRAINED_EXTRA = "text_model.embeddings.token_embedding.trained_extra"


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"   # SD2.x's OpenCLIP-derived encoder: "gelu"
    # CLIPTextModelWithProjection (SDXL text encoder 2): pooled EOS state
    # projected to this width; None = no projection head.
    projection_dim: Optional[int] = None
    eos_token_id: int = 49407

    @classmethod
    def vit_l(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def sdxl_g(cls) -> "CLIPTextConfig":
        """SDXL text encoder 2 (OpenCLIP ViT-bigG in transformers layout,
        CLIPTextModelWithProjection)."""
        return cls(hidden_size=1280, intermediate_size=5120,
                   num_hidden_layers=32, num_attention_heads=20,
                   hidden_act="gelu", projection_dim=1280)

    @classmethod
    def sd21(cls) -> "CLIPTextConfig":
        """SD 2.x text encoder (OpenCLIP ViT-H in transformers CLIP layout)."""
        return cls(hidden_size=1024, intermediate_size=4096,
                   num_hidden_layers=23, num_attention_heads=16,
                   hidden_act="gelu")

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=77)


def clip_text_apply(params: Params, input_ids: torch.Tensor, config: CLIPTextConfig,
                    stop_at_layer: int = 1) -> torch.Tensor:
    """input_ids: (B, L) integer -> last hidden state (B, L, hidden).

    ``stop_at_layer=k`` drops the last ``k - 1`` transformer layers before the
    final layer norm (CLIP-skip).
    """
    x = _embed(params, input_ids)
    num_layers = config.num_hidden_layers - (stop_at_layer - 1)
    for i in range(num_layers):
        x = _encoder_layer(params, i, x, config)
    return layer_norm(params, "text_model.final_layer_norm", x)


def _embed(p: Params, input_ids: torch.Tensor) -> torch.Tensor:
    tok = p["text_model.embeddings.token_embedding.weight"]
    extra = p.get(TRAINED_EXTRA)
    if extra is not None:
        tok = torch.cat([tok, extra.to(tok.dtype)], dim=0)
    pos = p["text_model.embeddings.position_embedding.weight"]
    return tok[input_ids] + pos[:input_ids.shape[1]]


def _encoder_layer(p: Params, i: int, x: torch.Tensor,
                   config: CLIPTextConfig) -> torch.Tensor:
    heads = config.num_attention_heads
    head_dim = config.hidden_size // heads
    pre = f"text_model.encoder.layers.{i}"
    n = layer_norm(p, f"{pre}.layer_norm1", x)
    q = linear(p, f"{pre}.self_attn.q_proj", n)
    k = linear(p, f"{pre}.self_attn.k_proj", n)
    v = linear(p, f"{pre}.self_attn.v_proj", n)
    attn = multi_head_attention(q, k, v, heads, float(head_dim) ** -0.5, causal=True)
    x = x + linear(p, f"{pre}.self_attn.out_proj", attn)
    n = layer_norm(p, f"{pre}.layer_norm2", x)
    h = linear(p, f"{pre}.mlp.fc1", n)
    h = quick_gelu(h) if config.hidden_act == "quick_gelu" else gelu(h)
    return x + linear(p, f"{pre}.mlp.fc2", h)


def clip_text_encode_sdxl(params: Params, input_ids: torch.Tensor, config: CLIPTextConfig
                          ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """SDXL's encode (diffusers ``StableDiffusionXLPipeline.encode_prompt``):
    (the penultimate hidden state without the final layer norm, the pooled
    projected embedding or None). The pooled vector runs the whole stack,
    the final layer norm, the gather at each row's EOS, then
    ``text_projection`` (towers with a projection head only)."""
    x = _embed(params, input_ids)
    last = config.num_hidden_layers - 1
    for i in range(last):
        x = _encoder_layer(params, i, x, config)
    penult, pooled = x, None
    if config.projection_dim is not None:
        # a tower without a projection head never reads its last layer
        x = layer_norm(params, "text_model.final_layer_norm",
                       _encoder_layer(params, last, x, config))
        eos = eos_positions(input_ids, config.eos_token_id)
        gathered = x[torch.arange(x.shape[0], device=x.device), eos]
        pooled = gathered @ params["text_projection.weight"].to(gathered.dtype).T
    return penult, pooled


def second_tower_ids(input_ids: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """SDXL tower 2's ids: SDXL's second tokenizer pads with 0 after the
    first EOS (the first pads with EOS)."""
    first_eos = eos_positions(input_ids, eos_token_id)
    pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    return torch.where(pos > first_eos[:, None], torch.zeros_like(input_ids), input_ids)


def encode_sdxl(clip_params: Params, clip2_params: Params, input_ids: torch.Tensor,
                clip_config: CLIPTextConfig, clip2_config: CLIPTextConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SDXL's conditioning of ``input_ids`` (diffusers' SDXL encode_prompt):
    (both towers' raw penultimate states concatenated on features, tower 2's
    pooled projected embedding)."""
    penult1, _ = clip_text_encode_sdxl(clip_params, input_ids, clip_config)
    penult2, pooled = clip_text_encode_sdxl(
        clip2_params, second_tower_ids(input_ids, clip_config.eos_token_id), clip2_config)
    return torch.cat([penult1, penult2], dim=-1), pooled


def eos_positions(input_ids: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """Per-row EOS position, (B,) int64.

    transformers parity quirk (modeling_clip.py): CLIP configs shipped with
    the legacy ``eos_token_id: 2`` use argmax(input_ids) (the highest token
    id, which is the real EOS 49407); otherwise the first true-EOS
    occurrence. Both take the FIRST maximal position, as JAX's argmax does.
    """
    hits = input_ids if eos_token_id == 2 else (input_ids == eos_token_id).int()
    top = hits.max(dim=-1, keepdim=True).values
    pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
    return torch.where(hits == top, pos, input_ids.shape[-1]).min(dim=-1).values


def clip_param_shapes(config: CLIPTextConfig) -> dict[str, tuple[int, ...]]:
    d, m = config.hidden_size, config.intermediate_size
    s: dict[str, tuple[int, ...]] = {
        "text_model.embeddings.token_embedding.weight": (config.vocab_size, d),
        "text_model.embeddings.position_embedding.weight": (config.max_position_embeddings, d),
        "text_model.final_layer_norm.weight": (d,),
        "text_model.final_layer_norm.bias": (d,),
    }
    for i in range(config.num_hidden_layers):
        pre = f"text_model.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            s[f"{pre}.{ln}.weight"] = (d,)
            s[f"{pre}.{ln}.bias"] = (d,)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[f"{pre}.self_attn.{proj}.weight"] = (d, d)
            s[f"{pre}.self_attn.{proj}.bias"] = (d,)
        s[f"{pre}.mlp.fc1.weight"] = (m, d)
        s[f"{pre}.mlp.fc1.bias"] = (m,)
        s[f"{pre}.mlp.fc2.weight"] = (d, m)
        s[f"{pre}.mlp.fc2.bias"] = (d,)
    if config.projection_dim is not None:
        s["text_projection.weight"] = (config.projection_dim, d)
    return s


def init_clip_params(config: CLIPTextConfig, seed: int = 0, device="cuda",
                     dtype: torch.dtype = torch.float32) -> Params:
    return init_params(clip_param_shapes(config), seed, device, dtype)
