"""MMDiT (SD3-family) state-dict bijection, sgm single file <-> diffusers
(port of ``scal_sdt_tpu/convert/mmdit_names.py``).

SD3/SD3.5 single-file checkpoints (the WebUI / ComfyUI distribution) store
the MMDiT under ``model.diffusion_model.*`` in the sgm reference naming
(``joint_blocks.{i}.x_block`` / ``context_block``, fused ``attn.qkv``), the
text towers under ``text_encoders.{clip_l,clip_g,t5xxl}.transformer.*`` (in
transformers layout already) and the 16-channel VAE under
``first_stage_model.*``. The port's names are diffusers'
``SD3Transformer2DModel`` (``models/mmdit.py``), so loading and publishing go
through the map below: the fused qkv chunked into thirds, and the two
continuous adaLN heads' halves swapped (sgm stores [shift, scale], diffusers
[scale, shift]; diffusers' ``scripts/convert_sd3_to_diffusers.py``).
"""

from __future__ import annotations

import logging
import re
from typing import Iterable, Optional

import torch

from ..models.mmdit import POS_EMBED_KEY, MMDiTConfig

__all__ = [
    "convert_mmdit_state_sgm_to_df",
    "convert_mmdit_state_df_to_sgm",
    "mmdit_config_from_sgm_state",
]

logger = logging.getLogger(__name__)

# sgm name (relative to model.diffusion_model.) <-> diffusers name, for the
# tensors outside the blocks; the adaLN heads that swap halves are apart
_TOP_LEVEL = [
    ("x_embedder.proj.weight", "pos_embed.proj.weight"),
    ("x_embedder.proj.bias", "pos_embed.proj.bias"),
    ("pos_embed", POS_EMBED_KEY),
    ("t_embedder.mlp.0.weight", "time_text_embed.timestep_embedder.linear_1.weight"),
    ("t_embedder.mlp.0.bias", "time_text_embed.timestep_embedder.linear_1.bias"),
    ("t_embedder.mlp.2.weight", "time_text_embed.timestep_embedder.linear_2.weight"),
    ("t_embedder.mlp.2.bias", "time_text_embed.timestep_embedder.linear_2.bias"),
    ("y_embedder.mlp.0.weight", "time_text_embed.text_embedder.linear_1.weight"),
    ("y_embedder.mlp.0.bias", "time_text_embed.text_embedder.linear_1.bias"),
    ("y_embedder.mlp.2.weight", "time_text_embed.text_embedder.linear_2.weight"),
    ("y_embedder.mlp.2.bias", "time_text_embed.text_embedder.linear_2.bias"),
    ("context_embedder.weight", "context_embedder.weight"),
    ("context_embedder.bias", "context_embedder.bias"),
    ("final_layer.linear.weight", "proj_out.weight"),
    ("final_layer.linear.bias", "proj_out.bias"),
]

# per-block suffix pairs (sgm, diffusers) copied straight through; the fused
# qkv and the pre_only context adaLN are apart
_BLOCK_DIRECT = [
    ("x_block.attn.proj.weight", "attn.to_out.0.weight"),
    ("x_block.attn.proj.bias", "attn.to_out.0.bias"),
    # SD3.5-Medium's dual attention (MMDiT-X): the latent-only second attention
    ("x_block.attn2.proj.weight", "attn2.to_out.0.weight"),
    ("x_block.attn2.proj.bias", "attn2.to_out.0.bias"),
    ("x_block.attn2.ln_q.weight", "attn2.norm_q.weight"),
    ("x_block.attn2.ln_k.weight", "attn2.norm_k.weight"),
    ("context_block.attn.proj.weight", "attn.to_add_out.weight"),
    ("context_block.attn.proj.bias", "attn.to_add_out.bias"),
    ("x_block.attn.ln_q.weight", "attn.norm_q.weight"),
    ("x_block.attn.ln_k.weight", "attn.norm_k.weight"),
    ("context_block.attn.ln_q.weight", "attn.norm_added_q.weight"),
    ("context_block.attn.ln_k.weight", "attn.norm_added_k.weight"),
    ("x_block.adaLN_modulation.1.weight", "norm1.linear.weight"),
    ("x_block.adaLN_modulation.1.bias", "norm1.linear.bias"),
    ("x_block.mlp.fc1.weight", "ff.net.0.proj.weight"),
    ("x_block.mlp.fc1.bias", "ff.net.0.proj.bias"),
    ("x_block.mlp.fc2.weight", "ff.net.2.weight"),
    ("x_block.mlp.fc2.bias", "ff.net.2.bias"),
    ("context_block.mlp.fc1.weight", "ff_context.net.0.proj.weight"),
    ("context_block.mlp.fc1.bias", "ff_context.net.0.proj.bias"),
    ("context_block.mlp.fc2.weight", "ff_context.net.2.weight"),
    ("context_block.mlp.fc2.bias", "ff_context.net.2.bias"),
]

_QKV = [("x_block.attn.qkv", "attn.to_q", "attn.to_k", "attn.to_v"),
        ("context_block.attn.qkv", "attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj"),
        ("x_block.attn2.qkv", "attn2.to_q", "attn2.to_k", "attn2.to_v")]


def _swap_scale_shift(w: torch.Tensor) -> torch.Tensor:
    """sgm's continuous adaLN heads emit [shift, scale], diffusers'
    AdaLayerNormContinuous [scale, shift]. An involution: the same swap
    converts both ways."""
    half = w.shape[0] // 2
    return torch.cat([w[half:], w[:half]], dim=0)


def _count_blocks(names: Iterable[str], pat: str) -> int:
    rx = re.compile(pat)
    idx = [int(m.group(1)) for n in names if (m := rx.match(n))]
    return max(idx) + 1 if idx else 0


def _infer_inner_dim(state: dict) -> Optional[int]:
    """The MMDiT width d from any tensor that touches it: adaLN heads,
    attention projections and the x embedder take d as their input (shape
    [1]); the MLP out-projections map 4d -> d, so d is their output
    (shape [0])."""
    for k, v in state.items():
        if k.endswith((".adaLN_modulation.1.weight", "norm1.linear.weight",
                       "norm1_context.linear.weight", "attn.to_q.weight", "attn.qkv.weight")):
            return int(v.shape[1])
        if k.endswith(("ff.net.2.weight", "mlp.fc2.weight")):
            return int(v.shape[0])
    return None


def _ctx_adaln_is_continuous(state: dict, wkey: str, bkey: str, inner_dim: Optional[int],
                             fallback: bool) -> bool:
    """Whether a block's context adaLN head is the 2-chunk continuous one
    (the context_pre_only last block) rather than the 6-chunk adaLN-zero:
    read from the head's own output width (2d against 6d), not from the
    block index, so a partial trainable-only state whose highest block is
    not the model's last converts right. Falls back to the index only for a
    bias-only head in a state with no width-bearing tensor."""
    if wkey in state:
        w = state[wkey]
        return int(w.shape[0]) == 2 * int(w.shape[1])
    if bkey in state and inner_dim:
        return int(state[bkey].shape[0]) == 2 * inner_dim
    return fallback


def convert_mmdit_state_sgm_to_df(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """sgm MMDiT state (relative to ``model.diffusion_model.``) -> diffusers
    ``SD3Transformer2DModel`` names."""
    n = _count_blocks(state, r"joint_blocks\.(\d+)\.")
    if n == 0:
        raise ValueError("No joint_blocks.* keys: not an sgm MMDiT state")
    out: dict[str, torch.Tensor] = {}
    consumed = set()

    def take(name):
        consumed.add(name)
        return state[name]

    for sgm, df in _TOP_LEVEL:
        if sgm in state:
            out[df] = take(sgm)
    # pos_embed may be stored (max*max, d); the port's is (1, max*max, d)
    if POS_EMBED_KEY in out and out[POS_EMBED_KEY].dim() == 2:
        out[POS_EMBED_KEY] = out[POS_EMBED_KEY][None]
    for suffix in ("weight", "bias"):
        k = f"final_layer.adaLN_modulation.1.{suffix}"
        if k in state:
            out[f"norm_out.linear.{suffix}"] = _swap_scale_shift(take(k))

    inner_dim = _infer_inner_dim(state)
    for i in range(n):
        pre_sgm, pre_df = f"joint_blocks.{i}.", f"transformer_blocks.{i}."
        for sgm_suf, df_suf in _BLOCK_DIRECT:
            k = pre_sgm + sgm_suf
            if k in state:
                out[pre_df + df_suf] = take(k)
        for sgm_suf, q, kk, v in _QKV:
            for wb in ("weight", "bias"):
                k = f"{pre_sgm}{sgm_suf}.{wb}"
                if k in state:
                    parts = torch.chunk(take(k), 3, dim=0)
                    for name, part in zip((q, kk, v), parts):
                        out[f"{pre_df}{name}.{wb}"] = part
        pre_only = _ctx_adaln_is_continuous(
            state, f"{pre_sgm}context_block.adaLN_modulation.1.weight",
            f"{pre_sgm}context_block.adaLN_modulation.1.bias", inner_dim, i == n - 1)
        for wb in ("weight", "bias"):
            k = f"{pre_sgm}context_block.adaLN_modulation.1.{wb}"
            if k in state:
                val = take(k)
                out[f"{pre_df}norm1_context.linear.{wb}"] = (
                    _swap_scale_shift(val) if pre_only else val)

    leftover = [k for k in state if k not in consumed]
    if leftover:
        preview = ", ".join(sorted(leftover)[:8])
        raise ValueError(f"sgm MMDiT state has {len(leftover)} unconsumed keys (first: {preview})")
    return out


def convert_mmdit_state_df_to_sgm(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """diffusers ``SD3Transformer2DModel`` names -> sgm single-file names
    (relative to ``model.diffusion_model.``). Takes partial states (a
    trainable-only checkpoint) as long as each fused qkv triple is whole."""
    n = _count_blocks(state, r"transformer_blocks\.(\d+)\.")
    out: dict[str, torch.Tensor] = {}
    consumed = set()

    for sgm, df in _TOP_LEVEL:
        if df in state:
            out[sgm] = state[df]
            consumed.add(df)
    for suffix in ("weight", "bias"):
        k = f"norm_out.linear.{suffix}"
        if k in state:
            out[f"final_layer.adaLN_modulation.1.{suffix}"] = _swap_scale_shift(state[k])
            consumed.add(k)

    inner_dim = _infer_inner_dim(state)
    for i in range(n):
        pre_sgm, pre_df = f"joint_blocks.{i}.", f"transformer_blocks.{i}."
        for sgm_suf, df_suf in _BLOCK_DIRECT:
            k = pre_df + df_suf
            if k in state:
                out[pre_sgm + sgm_suf] = state[k]
                consumed.add(k)
        for sgm_suf, q, kk, v in _QKV:
            for wb in ("weight", "bias"):
                names = [f"{pre_df}{p}.{wb}" for p in (q, kk, v)]
                present = [nm for nm in names if nm in state]
                if not present:
                    continue
                if len(present) != 3:
                    raise ValueError(
                        f"Partial fused-qkv triple at {pre_df}attn ({len(present)}/3 of "
                        f"{q}/{kk}/{v}.{wb}): cannot emit the sgm fused tensor")
                out[f"{pre_sgm}{sgm_suf}.{wb}"] = torch.cat([state[nm] for nm in names], dim=0)
                consumed.update(names)
        pre_only = _ctx_adaln_is_continuous(
            state, f"{pre_df}norm1_context.linear.weight", f"{pre_df}norm1_context.linear.bias",
            inner_dim, i == n - 1)
        for wb in ("weight", "bias"):
            k = f"{pre_df}norm1_context.linear.{wb}"
            if k in state:
                val = state[k]
                out[f"{pre_sgm}context_block.adaLN_modulation.1.{wb}"] = (
                    _swap_scale_shift(val) if pre_only else val)
                consumed.add(k)

    leftover = [k for k in state if k not in consumed]
    if leftover:
        preview = ", ".join(sorted(leftover)[:8])
        raise ValueError(
            f"diffusers MMDiT state has {len(leftover)} unconsumed keys (first: {preview})")
    return out


def mmdit_config_from_sgm_state(state: dict[str, torch.Tensor], head_dim: int = 64,
                                pos_embed_max_size: Optional[int] = None) -> MMDiTConfig:
    """The MMDiTConfig of an sgm-layout MMDiT state, from its shapes (a
    single file carries no config.json). The head dim, 64 in every SD3 /
    SD3.5 release, cannot be read from shapes; tiny fixtures pass theirs.
    ``pos_embed_max_size`` sizes the sincos grid of a file without the
    fixed buffer (else it is read from the buffer, or defaults to
    SD3-Medium's 192 with a warning)."""
    xw = state["x_embedder.proj.weight"]
    d, cin, ps = int(xw.shape[0]), int(xw.shape[1]), int(xw.shape[2])
    if d % head_dim != 0:
        raise ValueError(
            f"MMDiT width {d} is not divisible by head_dim {head_dim}; the head count cannot "
            "be inferred from a single-file checkpoint — pass head_dim explicitly")
    n = _count_blocks(state, r"joint_blocks\.(\d+)\.")
    if "pos_embed" in state:
        max_size = int(round(float(state["pos_embed"].shape[-2]) ** 0.5))
        if pos_embed_max_size is not None and pos_embed_max_size != max_size:
            raise ValueError(
                f"pos_embed_max_size override {pos_embed_max_size} conflicts with the "
                f"checkpoint's own sincos table ({max_size})")
    elif pos_embed_max_size is not None:
        max_size = int(pos_embed_max_size)
    else:
        max_size = 192
        logger.warning(
            "sgm MMDiT state has no pos_embed buffer; defaulting pos_embed_max_size=192 "
            "(SD3-Medium). Pass mmdit_pos_embed_max_size in the config / "
            "--pos-embed-max-size if this is a different variant.")
    cout = int(state["final_layer.linear.weight"].shape[0]) // (ps * ps)
    return MMDiTConfig(
        patch_size=ps, in_channels=cin, out_channels=cout, num_layers=n,
        attention_head_dim=head_dim, num_attention_heads=d // head_dim,
        joint_attention_dim=int(state["context_embedder.weight"].shape[1]),
        pooled_projection_dim=int(state["y_embedder.mlp.0.weight"].shape[1]),
        pos_embed_max_size=max_size,
        qk_norm="rms_norm" if "joint_blocks.0.x_block.attn.ln_q.weight" in state else None,
        dual_attention_layers=tuple(i for i in range(n)
                                    if f"joint_blocks.{i}.x_block.attn2.qkv.weight" in state),
    )
