"""SD1.x/2.x/SDXL conditional UNet over a flat param dict (port of
``scal_sdt_tpu/models/unet.py``), NCHW activations.

Same parameter names and shapes as the JAX package (diffusers'
``UNet2DConditionModel`` state-dict names, torch layouts), so a JAX param
dict converts with ``convert.from_jax.params_from_jax`` alone. Self- and
cross-attention go through ``ops.attention.multi_head_attention``, whose
gate sends the long self-attention of the high-resolution levels to the
splash kernels on CUDA. ``remat`` mirrors the JAX modes with
``torch.utils.checkpoint``.

SDXL's text_time conditioning (``addition_embed_type="text_time"``): the six
``time_ids`` (original size, crop offsets, target size) are fourier-embedded
at ``addition_time_embed_dim`` each, concatenated after the pooled text
embedding and added to the time embedding through ``add_embedding``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention
from ..parallel.tensor import TENSOR_PARALLEL
from .functional import (Params, conv2d, gelu, group_norm, init_params, layer_norm, linear,
                         silu, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # int (SD1.x: 8) or per-level tuple; diffusers' attention_head_dim, which
    # holds the HEAD COUNT despite its name.
    num_attention_heads: int | tuple[int, ...] = 8
    use_linear_projection: bool = False
    cross_attention_dim: int = 768
    transformer_layers_per_block: int | tuple[int, ...] = 1
    addition_embed_type: Optional[str] = None    # SDXL: "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None
    down_block_types: tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    norm_num_groups: int = 32
    sample_size: int = 64
    flip_sin_to_cos: bool = True
    freq_shift: int = 0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def sd21(cls) -> "UNetConfig":
        """SD 2.x: head dim 64 (per-level head counts), linear projections,
        OpenCLIP-H context width."""
        return cls(num_attention_heads=(5, 10, 20, 20), use_linear_projection=True,
                   cross_attention_dim=1024)

    @classmethod
    def sdxl(cls) -> "UNetConfig":
        """SDXL-base (diffusers stabilityai/stable-diffusion-xl-base-1.0
        unet/config.json): 3 levels, transformer depths (1, 2, 10), context
        width 2048 (both text towers), text_time micro-conditioning."""
        return cls(
            block_out_channels=(320, 640, 1280),
            num_attention_heads=(5, 10, 20),
            use_linear_projection=True,
            cross_attention_dim=2048,
            transformer_layers_per_block=(1, 2, 10),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
            addition_embed_type="text_time",
            addition_time_embed_dim=256,
            projection_class_embeddings_input_dim=2816,
            sample_size=128,
        )

    @classmethod
    def tiny_sdxl(cls) -> "UNetConfig":
        """Miniature SDXL-shaped variant for CPU tests (same as the JAX
        package's)."""
        return cls(
            block_out_channels=(32, 64),
            layers_per_block=1,
            num_attention_heads=(2, 4),
            use_linear_projection=True,
            cross_attention_dim=64,
            transformer_layers_per_block=(1, 2),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
            addition_embed_type="text_time",
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=32 + 6 * 8,  # pooled 32 + ids
            norm_num_groups=8,
            sample_size=8,
        )

    @classmethod
    def tiny(cls) -> "UNetConfig":
        """Miniature variant for CPU tests (same as the JAX package's)."""
        return cls(
            block_out_channels=(32, 64),
            layers_per_block=1,
            num_attention_heads=2,
            cross_attention_dim=32,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            norm_num_groups=8,
        )

    @classmethod
    def from_sgm_config(cls, ldm_config) -> "UNetConfig":
        """SDXL's sgm architecture YAML (``network_config`` in place of
        ``unet_config``; per-level ``transformer_depth``; text_time
        micro-conditioning from ``adm_in_channels`` with sequential
        classes)."""
        u = ldm_config.model.params.network_config.params
        mult = list(u.channel_mult)
        block_out = tuple(int(u.model_channels) * m for m in mult)
        attn_ds = {int(a) for a in u.attention_resolutions}
        has_attn = [2 ** i in attn_ds for i in range(len(mult))]
        depth = u.get("transformer_depth", 1)
        depth = tuple(int(d) for d in depth) if isinstance(depth, (list, tuple)) else int(depth)
        heads = (tuple(c // int(u.num_head_channels) for c in block_out)
                 if "num_head_channels" in u else int(u.get("num_heads", 8)))
        text_time = str(u.get("num_classes", "")) == "sequential" and u.get("adm_in_channels")
        return cls(
            in_channels=int(u.in_channels),
            out_channels=int(u.out_channels),
            block_out_channels=block_out,
            layers_per_block=int(u.num_res_blocks),
            num_attention_heads=heads,
            use_linear_projection=bool(u.get("use_linear_in_transformer", False)),
            cross_attention_dim=int(u.context_dim),
            transformer_layers_per_block=depth,
            down_block_types=tuple("CrossAttnDownBlock2D" if a else "DownBlock2D"
                                   for a in has_attn),
            up_block_types=tuple("CrossAttnUpBlock2D" if a else "UpBlock2D"
                                 for a in reversed(has_attn)),
            addition_embed_type="text_time" if text_time else None,
            projection_class_embeddings_input_dim=int(u.adm_in_channels) if text_time else None,
            # fixed in real SD UNets; extensions for tiny fixtures
            addition_time_embed_dim=int(u.get("addition_time_embed_dim", 256)),
            norm_num_groups=int(u.get("num_groups", 32)),
        )

    @classmethod
    def from_ldm_config(cls, ldm_config) -> "UNetConfig":
        """The shapes of a CompVis LDM architecture YAML (``unet_config``).
        Attention sits at the levels whose downscale factor is in
        ``attention_resolutions``; SD1.x sets ``num_heads``, SD2.x
        ``num_head_channels`` (64), which gives per-level head counts. Like
        the JAX package, it reads no ``parameterization``: an SD2 v model
        needs ``schedule: {prediction_type: v}`` in the run config."""
        u = ldm_config.model.params.unet_config.params
        mult = list(u.channel_mult)
        block_out = tuple(int(u.model_channels) * m for m in mult)
        attn_res = set(u.attention_resolutions)
        factors = [2 ** i for i in range(len(mult))]
        heads = (tuple(c // int(u.num_head_channels) for c in block_out)
                 if "num_head_channels" in u else int(u.get("num_heads", 8)))
        return cls(
            in_channels=int(u.in_channels),
            out_channels=int(u.out_channels),
            block_out_channels=block_out,
            layers_per_block=int(u.num_res_blocks),
            num_attention_heads=heads,
            use_linear_projection=bool(u.get("use_linear_in_transformer", False)),
            cross_attention_dim=int(u.context_dim),
            down_block_types=tuple("CrossAttnDownBlock2D" if f in attn_res else "DownBlock2D"
                                   for f in factors),
            up_block_types=tuple("CrossAttnUpBlock2D" if f in attn_res else "UpBlock2D"
                                 for f in reversed(factors)),
        )

    def heads_at(self, level: int) -> int:
        h = self.num_attention_heads
        return h[level] if isinstance(h, (tuple, list)) else int(h)

    def tf_depth_at(self, level: int) -> int:
        d = self.transformer_layers_per_block
        return d[level] if isinstance(d, (tuple, list)) else int(d)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _resnet(p: Params, pre: str, x: torch.Tensor, temb: torch.Tensor, groups: int) -> torch.Tensor:
    h = silu(group_norm(p, f"{pre}.norm1", x, groups))
    h = conv2d(p, f"{pre}.conv1", h)
    if f"{pre}.time_emb_proj.weight" in p:
        t = linear(p, f"{pre}.time_emb_proj", silu(temb))
        h = h + t[:, :, None, None]
    h = silu(group_norm(p, f"{pre}.norm2", h, groups))
    h = conv2d(p, f"{pre}.conv2", h)
    if f"{pre}.conv_shortcut.weight" in p:
        x = conv2d(p, f"{pre}.conv_shortcut", x, padding=0)
    return x + h


def _cross_attn(p: Params, pre: str, x: torch.Tensor, context: torch.Tensor,
                num_heads: int) -> torch.Tensor:
    tp = p.get(TENSOR_PARALLEL)
    if tp is not None:   # the rank's heads of a tensor-split attention
        num_heads = tp.heads(f"{pre}.to_q", num_heads)
    q = linear(p, f"{pre}.to_q", x)
    k = linear(p, f"{pre}.to_k", context)
    v = linear(p, f"{pre}.to_v", context)
    head_dim = q.shape[-1] // num_heads
    out = multi_head_attention(q, k, v, num_heads, float(head_dim) ** -0.5)
    return linear(p, f"{pre}.to_out.0", out)


def _transformer_block(p: Params, pre: str, x: torch.Tensor, context: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    n1 = layer_norm(p, f"{pre}.norm1", x)
    x = x + _cross_attn(p, f"{pre}.attn1", n1, n1, num_heads)
    x = x + _cross_attn(p, f"{pre}.attn2", layer_norm(p, f"{pre}.norm2", x), context, num_heads)
    h = linear(p, f"{pre}.ff.net.0.proj", layer_norm(p, f"{pre}.norm3", x))
    h, gate = h.chunk(2, dim=-1)
    return x + linear(p, f"{pre}.ff.net.2", h * gelu(gate))


def _spatial_transformer(p: Params, pre: str, x: torch.Tensor, context: torch.Tensor,
                         num_heads: int, groups: int) -> torch.Tensor:
    b, c, h, w = x.shape
    residual = x
    x = group_norm(p, f"{pre}.norm", x, groups, eps=1e-6)
    # SD1.x: 1x1 conv projections; SD2.x: nn.Linear (diffusers also swaps the
    # order of reshape and projection between the two).
    proj_linear = p[f"{pre}.proj_in.weight"].ndim == 2
    if proj_linear:
        x = linear(p, f"{pre}.proj_in", x.permute(0, 2, 3, 1).reshape(b, h * w, c))
    else:
        x = conv2d(p, f"{pre}.proj_in", x, padding=0).permute(0, 2, 3, 1).reshape(b, h * w, c)
    i = 0
    while f"{pre}.transformer_blocks.{i}.norm1.weight" in p:
        x = _transformer_block(p, f"{pre}.transformer_blocks.{i}", x, context, num_heads)
        i += 1
    if proj_linear:
        x = linear(p, f"{pre}.proj_out", x).reshape(b, h, w, c).permute(0, 3, 1, 2)
    else:
        x = conv2d(p, f"{pre}.proj_out", x.reshape(b, h, w, c).permute(0, 3, 1, 2), padding=0)
    return x + residual


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _text_time_embedding(params: Params, added_cond: Optional[dict], config: UNetConfig,
                         dtype: torch.dtype) -> torch.Tensor:
    """SDXL's addition embedding: fourier features of each of the six fp32
    ``time_ids``, after the pooled ``text_embeds``, through
    ``add_embedding.linear_1`` -> SiLU -> ``linear_2``."""
    if added_cond is None:
        raise ValueError("this UNet uses text_time conditioning: pass "
                         "added_cond={'text_embeds': (B, D), 'time_ids': (B, 6)}")
    time_ids = added_cond["time_ids"]
    b = time_ids.shape[0]
    ids_emb = timestep_embedding(
        time_ids.reshape(-1), config.addition_time_embed_dim,
        flip_sin_to_cos=config.flip_sin_to_cos,
        downscale_freq_shift=float(config.freq_shift),
        dtype=dtype,
    ).reshape(b, -1)
    add = torch.cat([added_cond["text_embeds"].to(dtype), ids_emb], dim=-1)
    return linear(params, "add_embedding.linear_2",
                  silu(linear(params, "add_embedding.linear_1", add)))


def unet_apply(params: Params, sample: torch.Tensor, timesteps: torch.Tensor,
               context: torch.Tensor, config: UNetConfig,
               remat: bool | str = False, added_cond: Optional[dict] = None) -> torch.Tensor:
    """Denoising forward pass.

    sample: (B, C_in, H, W) latents; timesteps: (B,) integer;
    context: (B, L, cross_attention_dim). Returns (B, C_out, H, W).
    added_cond (text_time UNets): {'text_embeds': (B, D) pooled embedding,
    'time_ids': (B, 6) fp32}.

    remat: False | True | 'high' | 'top', as in the JAX package: True
    checkpoints every block, 'high' the highest-resolution blocks (first
    down level, last two up levels), 'top' the first down and the last up
    level only.
    """
    if config.addition_embed_type not in (None, "text_time"):
        raise ValueError(f"addition_embed_type={config.addition_embed_type!r} is not supported")
    g = config.norm_num_groups
    n_down = len(config.down_block_types)
    n_up = len(config.up_block_types)

    def maybe_ckpt(fn, high_res: bool = False, top_res: bool = False):
        if (remat is True or (remat == "high" and high_res)
                or (remat == "top" and top_res)):
            return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                            preserve_rng_state=False)
        return fn

    t_feat = timestep_embedding(
        timesteps, config.block_out_channels[0],
        flip_sin_to_cos=config.flip_sin_to_cos,
        downscale_freq_shift=float(config.freq_shift),
        dtype=sample.dtype,
    )
    temb = linear(params, "time_embedding.linear_2",
                  silu(linear(params, "time_embedding.linear_1", t_feat)))
    if config.addition_embed_type == "text_time":
        temb = temb + _text_time_embedding(params, added_cond, config, sample.dtype)

    h = conv2d(params, "conv_in", sample)
    skips = [h]

    for i, block_type in enumerate(config.down_block_types):
        has_attn = block_type == "CrossAttnDownBlock2D"
        for j in range(config.layers_per_block):
            def down_unit(h_, temb_, context_, i=i, j=j, has_attn=has_attn):
                h_ = _resnet(params, f"down_blocks.{i}.resnets.{j}", h_, temb_, g)
                if has_attn:
                    h_ = _spatial_transformer(params, f"down_blocks.{i}.attentions.{j}", h_,
                                              context_, config.heads_at(i), g)
                return h_

            h = maybe_ckpt(down_unit, high_res=(i == 0), top_res=(i == 0))(h, temb, context)
            skips.append(h)
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in params:
            h = conv2d(params, f"down_blocks.{i}.downsamplers.0.conv", h, stride=2)
            skips.append(h)

    def mid_unit(h_, temb_, context_):
        h_ = _resnet(params, "mid_block.resnets.0", h_, temb_, g)
        h_ = _spatial_transformer(params, "mid_block.attentions.0", h_, context_,
                                  config.heads_at(n_down - 1), g)
        return _resnet(params, "mid_block.resnets.1", h_, temb_, g)

    h = maybe_ckpt(mid_unit)(h, temb, context)

    for i, block_type in enumerate(config.up_block_types):
        has_attn = block_type == "CrossAttnUpBlock2D"
        for j in range(config.layers_per_block + 1):
            skip = skips.pop()

            def up_unit(h_, skip_, temb_, context_, i=i, j=j, has_attn=has_attn):
                h_ = torch.cat([h_, skip_], dim=1)
                h_ = _resnet(params, f"up_blocks.{i}.resnets.{j}", h_, temb_, g)
                if has_attn:
                    h_ = _spatial_transformer(params, f"up_blocks.{i}.attentions.{j}", h_,
                                              context_, config.heads_at(n_up - 1 - i), g)
                return h_

            h = maybe_ckpt(up_unit, high_res=(i >= n_up - 2),
                           top_res=(i == n_up - 1))(h, skip, temb, context)
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in params:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = conv2d(params, f"up_blocks.{i}.upsamplers.0.conv", h)

    h = silu(group_norm(params, "conv_norm_out", h, g))
    return conv2d(params, "conv_out", h)


# ---------------------------------------------------------------------------
# Parameter shape template + init
# ---------------------------------------------------------------------------

def _norm_shapes(pre: str, c: int) -> dict[str, tuple[int, ...]]:
    return {f"{pre}.weight": (c,), f"{pre}.bias": (c,)}


def _linear_shapes(pre: str, cin: int, cout: int, bias: bool = True) -> dict[str, tuple[int, ...]]:
    s = {f"{pre}.weight": (cout, cin)}
    if bias:
        s[f"{pre}.bias"] = (cout,)
    return s


def _conv_shapes(pre: str, cin: int, cout: int, k: int = 3) -> dict[str, tuple[int, ...]]:
    return {f"{pre}.weight": (cout, cin, k, k), f"{pre}.bias": (cout,)}


def _resnet_shapes(pre: str, cin: int, cout: int, temb: int) -> dict[str, tuple[int, ...]]:
    s = {}
    s.update(_norm_shapes(f"{pre}.norm1", cin))
    s.update(_conv_shapes(f"{pre}.conv1", cin, cout))
    s.update(_linear_shapes(f"{pre}.time_emb_proj", temb, cout))
    s.update(_norm_shapes(f"{pre}.norm2", cout))
    s.update(_conv_shapes(f"{pre}.conv2", cout, cout))
    if cin != cout:
        s.update(_conv_shapes(f"{pre}.conv_shortcut", cin, cout, k=1))
    return s


def _attn_shapes(pre: str, dim: int, context_dim: int) -> dict[str, tuple[int, ...]]:
    s = {}
    s.update(_linear_shapes(f"{pre}.to_q", dim, dim, bias=False))
    s.update(_linear_shapes(f"{pre}.to_k", context_dim, dim, bias=False))
    s.update(_linear_shapes(f"{pre}.to_v", context_dim, dim, bias=False))
    s.update(_linear_shapes(f"{pre}.to_out.0", dim, dim))
    return s


def _transformer_shapes(pre: str, dim: int, context_dim: int, linear_proj: bool,
                        depth: int) -> dict[str, tuple[int, ...]]:
    s = {}
    s.update(_norm_shapes(f"{pre}.norm", dim))
    proj = _linear_shapes if linear_proj else (lambda p, a, b: _conv_shapes(p, a, b, k=1))
    s.update(proj(f"{pre}.proj_in", dim, dim))
    for b in range(depth):
        tb = f"{pre}.transformer_blocks.{b}"
        s.update(_norm_shapes(f"{tb}.norm1", dim))
        s.update(_attn_shapes(f"{tb}.attn1", dim, dim))
        s.update(_norm_shapes(f"{tb}.norm2", dim))
        s.update(_attn_shapes(f"{tb}.attn2", dim, context_dim))
        s.update(_norm_shapes(f"{tb}.norm3", dim))
        s.update(_linear_shapes(f"{tb}.ff.net.0.proj", dim, dim * 8))
        s.update(_linear_shapes(f"{tb}.ff.net.2", dim * 4, dim))
    s.update(proj(f"{pre}.proj_out", dim, dim))
    return s


def unet_param_shapes(config: UNetConfig) -> dict[str, tuple[int, ...]]:
    s: dict[str, tuple[int, ...]] = {}
    ch = config.block_out_channels
    temb_dim = config.time_embed_dim
    ctx = config.cross_attention_dim

    s.update(_linear_shapes("time_embedding.linear_1", ch[0], temb_dim))
    s.update(_linear_shapes("time_embedding.linear_2", temb_dim, temb_dim))
    if config.addition_embed_type == "text_time":
        add_in = config.projection_class_embeddings_input_dim
        if add_in is None:
            raise ValueError("text_time conditioning requires "
                             "projection_class_embeddings_input_dim")
        s.update(_linear_shapes("add_embedding.linear_1", add_in, temb_dim))
        s.update(_linear_shapes("add_embedding.linear_2", temb_dim, temb_dim))
    s.update(_conv_shapes("conv_in", config.in_channels, ch[0]))

    out_c = ch[0]
    down_out_channels = [ch[0]]  # skip channels, mirrors the forward's skip list
    for i, block_type in enumerate(config.down_block_types):
        in_c, out_c = out_c, ch[i]
        has_attn = block_type == "CrossAttnDownBlock2D"
        for j in range(config.layers_per_block):
            s.update(_resnet_shapes(f"down_blocks.{i}.resnets.{j}",
                                    in_c if j == 0 else out_c, out_c, temb_dim))
            if has_attn:
                s.update(_transformer_shapes(f"down_blocks.{i}.attentions.{j}", out_c, ctx,
                                             config.use_linear_projection,
                                             config.tf_depth_at(i)))
            down_out_channels.append(out_c)
        if i != len(config.down_block_types) - 1:
            s.update(_conv_shapes(f"down_blocks.{i}.downsamplers.0.conv", out_c, out_c))
            down_out_channels.append(out_c)

    mid_c = ch[-1]
    s.update(_resnet_shapes("mid_block.resnets.0", mid_c, mid_c, temb_dim))
    s.update(_transformer_shapes("mid_block.attentions.0", mid_c, ctx,
                                 config.use_linear_projection, config.tf_depth_at(len(ch) - 1)))
    s.update(_resnet_shapes("mid_block.resnets.1", mid_c, mid_c, temb_dim))

    rev = list(reversed(ch))
    prev_out = mid_c
    for i, block_type in enumerate(config.up_block_types):
        out_ci = rev[i]
        has_attn = block_type == "CrossAttnUpBlock2D"
        for j in range(config.layers_per_block + 1):
            skip_c = down_out_channels.pop()
            in_c = (prev_out if j == 0 else out_ci) + skip_c
            s.update(_resnet_shapes(f"up_blocks.{i}.resnets.{j}", in_c, out_ci, temb_dim))
            if has_attn:
                s.update(_transformer_shapes(f"up_blocks.{i}.attentions.{j}", out_ci, ctx,
                                             config.use_linear_projection,
                                             config.tf_depth_at(len(ch) - 1 - i)))
        if i != len(config.up_block_types) - 1:
            s.update(_conv_shapes(f"up_blocks.{i}.upsamplers.0.conv", out_ci, out_ci))
        prev_out = out_ci

    s.update(_norm_shapes("conv_norm_out", ch[0]))
    s.update(_conv_shapes("conv_out", ch[0], config.out_channels))
    return s


def init_unet_params(config: UNetConfig, seed: int = 0, device="cuda",
                     dtype: torch.dtype = torch.float32) -> Params:
    """Random init from a seeded ``torch.Generator`` (``init_params``); real
    runs import pretrained weights. Draws differ from the JAX package's
    (different generators): tests convert the JAX params instead."""
    return init_params(unet_param_shapes(config), seed, device, dtype)
