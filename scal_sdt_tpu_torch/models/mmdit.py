"""MMDiT, the SD3 family's rectified-flow transformer, over a flat param dict
(port of ``scal_sdt_tpu/models/mmdit.py``), NCHW latents.

The multimodal diffusion transformer of Stable Diffusion 3
(arXiv:2403.03206): two token streams, latent and text, each with its own
adaLN-Zero conditioning on the timestep and the pooled text embedding, meet
in one joint attention per block. Parameter names and layouts are diffusers'
``SD3Transformer2DModel`` state dict, as in the JAX package, so a JAX param
dict converts with ``convert.from_jax.params_from_jax`` alone.

The joint attention runs through ``ops.attention.multi_head_attention``:
latent tokens first, then the text tokens (diffusers' JointAttnProcessor
order). At SD3's head dim 64 its length (4096 + 154 at 1024^2, 1024 + 154 at
512^2) is one that no kernel tile divides: the splash kernels bound the
ragged tail themselves, the TPU version's padded branch. SD3.5-Medium's
latent-only ``attn2`` (``dual_attention_layers``) runs through the same gate.
The last block is ``pre_only``: its text stream feeds the attention's keys
and values, and its output is dropped (no ``to_add_out``, no
``ff_context``).

Patchify is one strided convolution; the tokens are the patch grid in (h, w)
order, the order of the JAX package's NHWC reshape, and unpatchify puts each
token's ``(p1, p2, c)`` features back in that order. Timesteps are floats in
[0, 1000] (the flow schedule's ``sigma * N``), embedded with
``flip_sin_to_cos`` and shift 0. The conditioning of the text encoders is
``encode_sd3``: both projected CLIP towers' penultimate states side by side,
zero-padded to ``joint_attention_dim``, then T5's states after them on the
sequence axis when the model has T5; the pooled embedding is both towers'
projected ones side by side.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from ..parallel.tensor import TENSOR_PARALLEL
from .clip import CLIPTextConfig, clip_text_encode_sdxl, second_tower_ids
from .functional import Params, conv2d, init_params, linear, silu, timestep_embedding
from .t5 import T5Config, t5_encoder_apply

POS_EMBED_KEY = "pos_embed.pos_embed"


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    sample_size: int = 128            # latent grid (pixels / 8)
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096   # prompt-embed width (T5-XXL / padded CLIP)
    pooled_projection_dim: int = 2048  # concat(CLIP-L, CLIP-bigG) pooled
    pos_embed_max_size: int = 192
    # SD3.5 adds per-head RMS q/k norms ('rms_norm'); SD3-Medium has none
    qk_norm: Optional[str] = None
    # SD3.5-Medium (MMDiT-X): blocks with a second, latent-only attention
    dual_attention_layers: tuple[int, ...] = ()

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def sd3_medium(cls) -> "MMDiTConfig":
        # stabilityai/stable-diffusion-3-medium transformer/config.json
        return cls()

    @classmethod
    def tiny(cls) -> "MMDiTConfig":
        return cls(sample_size=8, patch_size=2, in_channels=4, out_channels=4,
                   num_layers=2, attention_head_dim=8, num_attention_heads=2,
                   joint_attention_dim=24, pooled_projection_dim=20, pos_embed_max_size=12)

    @classmethod
    def from_json(cls, d: dict) -> "MMDiTConfig":
        return cls(
            sample_size=int(d.get("sample_size", 128)),
            patch_size=int(d.get("patch_size", 2)),
            in_channels=int(d.get("in_channels", 16)),
            out_channels=int(d.get("out_channels", d.get("in_channels", 16))),
            num_layers=int(d.get("num_layers", 24)),
            attention_head_dim=int(d.get("attention_head_dim", 64)),
            num_attention_heads=int(d.get("num_attention_heads", 24)),
            joint_attention_dim=int(d.get("joint_attention_dim", 4096)),
            pooled_projection_dim=int(d.get("pooled_projection_dim", 2048)),
            pos_embed_max_size=int(d.get("pos_embed_max_size", 192)),
            qk_norm=d.get("qk_norm"),
            dual_attention_layers=tuple(d.get("dual_attention_layers") or ()),
        )


# --- building blocks -------------------------------------------------------------

def _layer_norm_noaffine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without scale or bias, statistics in fp32."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


def _chunks(p: Params, name: str, temb: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    """The ``n`` (B, 1, D) modulation vectors of an adaLN's linear."""
    return linear(p, f"{name}.linear", silu(temb))[:, None, :].chunk(n, dim=-1)


def _ada_ln_zero(p: Params, name: str, x: torch.Tensor, temb: torch.Tensor):
    """AdaLayerNormZero: LN(x) * (1 + scale) + shift, plus the attention and
    MLP gates. diffusers' chunk order: shift_msa, scale_msa, gate_msa,
    shift_mlp, scale_mlp, gate_mlp."""
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = _chunks(p, name, temb, 6)
    normed = _layer_norm_noaffine(x) * (1.0 + scale_msa) + shift_msa
    return normed, gate_msa, shift_mlp, scale_mlp, gate_mlp


def _ada_ln_zero_x(p: Params, name: str, x: torch.Tensor, temb: torch.Tensor):
    """SD35AdaLayerNormZeroX (dual-attention blocks): one LN, two
    shift/scale/gate triples, the second for the latent-only attn2."""
    (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp,
     shift_msa2, scale_msa2, gate_msa2) = _chunks(p, name, temb, 9)
    base = _layer_norm_noaffine(x)
    normed = base * (1.0 + scale_msa) + shift_msa
    normed2 = base * (1.0 + scale_msa2) + shift_msa2
    return normed, gate_msa, shift_mlp, scale_mlp, gate_mlp, normed2, gate_msa2


def _ada_ln_continuous(p: Params, name: str, x: torch.Tensor, temb: torch.Tensor
                       ) -> torch.Tensor:
    """AdaLayerNormContinuous: LN(x) * (1 + scale) + shift (chunk order:
    scale, shift)."""
    scale, shift = _chunks(p, name, temb, 2)
    return _layer_norm_noaffine(x) * (1.0 + scale) + shift


def _gelu_tanh_ff(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """diffusers FeedForward(activation_fn='gelu-approximate')."""
    h = F.gelu(linear(p, f"{name}.net.0.proj", x), approximate="tanh")
    return linear(p, f"{name}.net.2", h)


def _maybe_rms_head_norm(p: Params, name: str, x: torch.Tensor, num_heads: int
                         ) -> torch.Tensor:
    """SD3.5's per-head RMSNorm of q / k (attn.norm_q ...), in fp32."""
    w = p.get(f"{name}.weight")
    if w is None:
        return x
    b, l, c = x.shape
    xh = x.reshape(b, l, num_heads, c // num_heads).float()
    xh = xh * torch.rsqrt(torch.square(xh).mean(dim=-1, keepdim=True) + 1e-6)
    return (xh * w.float()).reshape(b, l, c).to(x.dtype)


def _qkv(p: Params, pre: str, x: torch.Tensor, names: tuple[str, str, str],
         norms: tuple[str, str], heads: int):
    q = _maybe_rms_head_norm(p, f"{pre}.{norms[0]}", linear(p, f"{pre}.{names[0]}", x), heads)
    k = _maybe_rms_head_norm(p, f"{pre}.{norms[1]}", linear(p, f"{pre}.{names[1]}", x), heads)
    return q, k, linear(p, f"{pre}.{names[2]}", x)


def _joint_block(p: Params, pre: str, hidden: torch.Tensor, context: torch.Tensor,
                 temb: torch.Tensor, config: MMDiTConfig, pre_only: bool, dual: bool = False):
    """One JointTransformerBlock: joint attention over [hidden; context].
    ``pre_only`` (the last block): the context stream's attention output is
    dropped, its norm is the continuous adaLN. ``dual``: the latent-only
    attn2 residual between the joint attention and the MLP."""
    h = config.num_attention_heads
    tp = p.get(TENSOR_PARALLEL)
    if tp is not None:   # the rank's heads of a tensor-split attention
        h = tp.heads(f"{pre}.attn.to_q", h)
    if dual:
        n_h, gate_msa, shift_mlp, scale_mlp, gate_mlp, n_h2, gate_msa2 = _ada_ln_zero_x(
            p, f"{pre}.norm1", hidden, temb)
    else:
        n_h, gate_msa, shift_mlp, scale_mlp, gate_mlp = _ada_ln_zero(
            p, f"{pre}.norm1", hidden, temb)
    if pre_only:
        n_c = _ada_ln_continuous(p, f"{pre}.norm1_context", context, temb)
        c_gates = None
    else:
        n_c, *c_gates = _ada_ln_zero(p, f"{pre}.norm1_context", context, temb)

    attn = f"{pre}.attn"
    q, k, v = _qkv(p, attn, n_h, ("to_q", "to_k", "to_v"), ("norm_q", "norm_k"), h)
    qc, kc, vc = _qkv(p, attn, n_c, ("add_q_proj", "add_k_proj", "add_v_proj"),
                      ("norm_added_q", "norm_added_k"), h)
    lh = hidden.shape[1]
    out = multi_head_attention(torch.cat([q, qc], dim=1), torch.cat([k, kc], dim=1),
                               torch.cat([v, vc], dim=1), h)
    attn_h, attn_c = out[:, :lh], out[:, lh:]

    hidden = hidden + gate_msa * linear(p, f"{attn}.to_out.0", attn_h)
    if dual:
        q2, k2, v2 = _qkv(p, f"{pre}.attn2", n_h2, ("to_q", "to_k", "to_v"),
                          ("norm_q", "norm_k"), h)
        hidden = hidden + gate_msa2 * linear(p, f"{pre}.attn2.to_out.0",
                                             multi_head_attention(q2, k2, v2, h))
    n2 = _layer_norm_noaffine(hidden) * (1.0 + scale_mlp) + shift_mlp
    hidden = hidden + gate_mlp * _gelu_tanh_ff(p, f"{pre}.ff", n2)

    if pre_only:
        return hidden, context
    c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = c_gates
    context = context + c_gate_msa * linear(p, f"{attn}.to_add_out", attn_c)
    n2c = _layer_norm_noaffine(context) * (1.0 + c_scale_mlp) + c_shift_mlp
    context = context + c_gate_mlp * _gelu_tanh_ff(p, f"{pre}.ff_context", n2c)
    return hidden, context


def cropped_pos_embed(pos: torch.Tensor, h_p: int, w_p: int, max_size: int) -> torch.Tensor:
    """Center crop of the (1, max*max, D) table to the (h_p, w_p) patch grid
    (diffusers PatchEmbed.cropped_pos_embed)."""
    d = pos.shape[-1]
    if h_p > max_size or w_p > max_size:
        raise ValueError(
            f"Latent patch grid {h_p}x{w_p} exceeds the model's sincos pos_embed table "
            f"({max_size}x{max_size}): the requested resolution is larger than this MMDiT "
            "supports (raise pos_embed_max_size or sample smaller)")
    grid = pos.reshape(max_size, max_size, d)
    top, left = (max_size - h_p) // 2, (max_size - w_p) // 2
    return grid[top:top + h_p, left:left + w_p].reshape(1, h_p * w_p, d)


def mmdit_apply(params: Params, latents: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor, pooled: torch.Tensor, config: MMDiTConfig
                ) -> torch.Tensor:
    """latents (B, C_in, H, W); timesteps (B,) float in [0, 1000]; context
    (B, L, joint_attention_dim); pooled (B, pooled_projection_dim). Returns
    the predicted flow velocity, (B, C_out, H, W)."""
    p = params
    dt = latents.dtype
    b, _, h_img, w_img = latents.shape
    ps = config.patch_size
    h_p, w_p = h_img // ps, w_img // ps

    # patchify: one strided conv, then the grid's tokens in (h, w) order
    x = conv2d(p, "pos_embed.proj", latents, stride=ps, padding=0)
    x = x.flatten(2).transpose(1, 2)
    x = x + cropped_pos_embed(p[POS_EMBED_KEY], h_p, w_p, config.pos_embed_max_size).to(dt)

    # timestep + pooled-text embedding (CombinedTimestepTextProjEmbeddings)
    t_freq = timestep_embedding(timesteps, 256, flip_sin_to_cos=True, downscale_freq_shift=0.0,
                                dtype=dt)
    t_emb = linear(p, "time_text_embed.timestep_embedder.linear_1", t_freq)
    t_emb = linear(p, "time_text_embed.timestep_embedder.linear_2", silu(t_emb))
    y_emb = linear(p, "time_text_embed.text_embedder.linear_1", pooled.to(dt))
    y_emb = linear(p, "time_text_embed.text_embedder.linear_2", silu(y_emb))
    temb = t_emb + y_emb

    c = linear(p, "context_embedder", context.to(dt))
    for i in range(config.num_layers):
        x, c = _joint_block(p, f"transformer_blocks.{i}", x, c, temb, config,
                            pre_only=i == config.num_layers - 1,
                            dual=i in config.dual_attention_layers)

    x = linear(p, "proj_out", _ada_ln_continuous(p, "norm_out", x, temb))
    # unpatchify: token features in (p1, p2, c) order
    x = x.reshape(b, h_p, w_p, ps, ps, config.out_channels)
    return x.permute(0, 5, 1, 3, 2, 4).reshape(b, config.out_channels, h_img, w_img)


# --- the SD3 conditioning ----------------------------------------------------------

def encode_sd3(clip_params: Params, clip2_params: Params, input_ids: torch.Tensor,
               clip_config: CLIPTextConfig, clip2_config: CLIPTextConfig, joint_dim: int,
               t5_params: Optional[Params] = None, t5_ids: Optional[torch.Tensor] = None,
               t5_config: Optional[T5Config] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(conds, pooled) of diffusers' SD3 encode_prompt: both towers'
    penultimate states side by side (tower 2's ids zeroed after the first
    EOS), zero-padded to ``joint_dim``, T5's last states (fp32, cast to the
    towers' dtype) after them on the sequence axis when ``t5_params`` is
    given; both projected pooled embeddings side by side."""
    penult1, pooled1 = clip_text_encode_sdxl(clip_params, input_ids, clip_config)
    penult2, pooled2 = clip_text_encode_sdxl(
        clip2_params, second_tower_ids(input_ids, clip_config.eos_token_id), clip2_config)
    emb = torch.cat([penult1, penult2], dim=-1)
    emb = F.pad(emb, (0, joint_dim - emb.shape[-1]))
    if t5_params is not None:
        emb = torch.cat([emb, t5_encoder_apply(t5_params, t5_ids, t5_config).to(emb.dtype)],
                        dim=1)
    return emb, torch.cat([pooled1, pooled2], dim=-1)


# --- parameter templates ---------------------------------------------------------------

def sincos_pos_embed_2d(dim: int, size: int) -> torch.Tensor:
    """(1, size*size, dim) fixed 2-D sin-cos table, fp32 (diffusers
    get_2d_sincos_pos_embed: grid order (h, w), [h-emb, w-emb]), computed in
    fp64 with numpy as the JAX package computes it."""
    def one_dim(positions: np.ndarray) -> np.ndarray:
        half = dim // 4
        omega = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float64) / half))
        out = np.einsum("p,f->pf", positions.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h, grid_w = np.meshgrid(np.arange(size, dtype=np.float64),
                                 np.arange(size, dtype=np.float64), indexing="ij")
    emb = np.concatenate([one_dim(grid_h), one_dim(grid_w)], axis=1)
    return torch.from_numpy(emb[None].astype(np.float32))


def mmdit_param_shapes(config: MMDiTConfig) -> dict[str, tuple[int, ...]]:
    d = config.inner_dim
    ps, cin, cout = config.patch_size, config.in_channels, config.out_channels
    shapes: dict[str, tuple[int, ...]] = {
        "pos_embed.proj.weight": (d, cin, ps, ps),
        "pos_embed.proj.bias": (d,),
        POS_EMBED_KEY: (1, config.pos_embed_max_size ** 2, d),
        "time_text_embed.timestep_embedder.linear_1.weight": (d, 256),
        "time_text_embed.timestep_embedder.linear_1.bias": (d,),
        "time_text_embed.timestep_embedder.linear_2.weight": (d, d),
        "time_text_embed.timestep_embedder.linear_2.bias": (d,),
        "time_text_embed.text_embedder.linear_1.weight": (d, config.pooled_projection_dim),
        "time_text_embed.text_embedder.linear_1.bias": (d,),
        "time_text_embed.text_embedder.linear_2.weight": (d, d),
        "time_text_embed.text_embedder.linear_2.bias": (d,),
        "context_embedder.weight": (d, config.joint_attention_dim),
        "context_embedder.bias": (d,),
        "norm_out.linear.weight": (2 * d, d),
        "norm_out.linear.bias": (2 * d,),
        "proj_out.weight": (ps * ps * cout, d),
        "proj_out.bias": (ps * ps * cout,),
    }
    head_dim = config.attention_head_dim
    for i in range(config.num_layers):
        pre = f"transformer_blocks.{i}"
        pre_only = i == config.num_layers - 1
        dual = i in config.dual_attention_layers
        nh = 9 if dual else 6
        shapes[f"{pre}.norm1.linear.weight"] = (nh * d, d)
        shapes[f"{pre}.norm1.linear.bias"] = (nh * d,)
        if dual:
            for proj in ("to_q", "to_k", "to_v", "to_out.0"):
                shapes[f"{pre}.attn2.{proj}.weight"] = (d, d)
                shapes[f"{pre}.attn2.{proj}.bias"] = (d,)
            if config.qk_norm:
                shapes[f"{pre}.attn2.norm_q.weight"] = (head_dim,)
                shapes[f"{pre}.attn2.norm_k.weight"] = (head_dim,)
        nc = 2 if pre_only else 6
        shapes[f"{pre}.norm1_context.linear.weight"] = (nc * d, d)
        shapes[f"{pre}.norm1_context.linear.bias"] = (nc * d,)
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                     "to_out.0"):
            shapes[f"{pre}.attn.{proj}.weight"] = (d, d)
            shapes[f"{pre}.attn.{proj}.bias"] = (d,)
        if config.qk_norm:
            for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                shapes[f"{pre}.attn.{n}.weight"] = (head_dim,)
        shapes[f"{pre}.ff.net.0.proj.weight"] = (4 * d, d)
        shapes[f"{pre}.ff.net.0.proj.bias"] = (4 * d,)
        shapes[f"{pre}.ff.net.2.weight"] = (d, 4 * d)
        shapes[f"{pre}.ff.net.2.bias"] = (d,)
        if not pre_only:
            shapes[f"{pre}.attn.to_add_out.weight"] = (d, d)
            shapes[f"{pre}.attn.to_add_out.bias"] = (d,)
            shapes[f"{pre}.ff_context.net.0.proj.weight"] = (4 * d, d)
            shapes[f"{pre}.ff_context.net.0.proj.bias"] = (4 * d,)
            shapes[f"{pre}.ff_context.net.2.weight"] = (d, 4 * d)
            shapes[f"{pre}.ff_context.net.2.bias"] = (d,)
    return shapes


def init_mmdit_params(config: MMDiTConfig, seed: int = 0, device="cuda",
                      dtype: torch.dtype = torch.float32) -> Params:
    """Random init from ``seed`` (``functional.init_params``: fan-in scaled
    weights, unit q/k norm scales, zero biases) with the fixed sincos
    ``pos_embed`` table; real runs load pretrained weights."""
    shapes = mmdit_param_shapes(config)
    del shapes[POS_EMBED_KEY]
    params = init_params(shapes, seed, device, dtype)
    params[POS_EMBED_KEY] = sincos_pos_embed_2d(config.inner_dim, config.pos_embed_max_size).to(
        params["proj_out.weight"].device, dtype)
    return params
