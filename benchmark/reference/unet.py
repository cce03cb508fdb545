"""Plain reference of Stable Diffusion's conditional UNet (diffusers'
``UNet2DConditionModel`` as SD 1.x builds it), float32, NCHW, over a flat
``{diffusers name: tensor}`` dict.

Read from the configuration file's own keys (``unet/config.json``):
``block_out_channels``, ``layers_per_block``, ``attention_head_dim`` (which
holds the head count in SD 1.x), ``cross_attention_dim``, the block types,
``norm_num_groups``, ``in_channels``, ``out_channels``, ``flip_sin_to_cos``
and ``freq_shift``. Resnets: GroupNorm, SiLU, 3x3 conv, the time embedding
added, again, a 1x1 shortcut where the width changes. Transformers: GroupNorm
(eps 1e-6), a 1x1 conv in and out, self-attention, cross-attention to the
text states and a GEGLU feed-forward, each behind a LayerNorm and a
residual. Nearest x2 upsampling, stride-2 conv downsampling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .numerics import Numerics, conv, group_norm, layer_norm, lin, sinusoidal


def _heads(cfg: dict, level: int) -> int:
    h = cfg["attention_head_dim"]
    return h[level] if isinstance(h, list) else int(h)


def _resnet(nx, p, pre, x, temb, groups):
    h = conv(nx, p, f"{pre}.conv1", F.silu(group_norm(p, f"{pre}.norm1", x, groups)))
    h = h + lin(nx, p, f"{pre}.time_emb_proj", F.silu(temb))[:, :, None, None]
    h = conv(nx, p, f"{pre}.conv2", F.silu(group_norm(p, f"{pre}.norm2", h, groups)))
    if f"{pre}.conv_shortcut.weight" in p:
        x = conv(nx, p, f"{pre}.conv_shortcut", x, padding=0)
    return x + h


def _attention(nx, p, pre, x, context, heads):
    q = lin(nx, p, f"{pre}.to_q", x)
    k = lin(nx, p, f"{pre}.to_k", context)
    v = lin(nx, p, f"{pre}.to_v", context)
    return lin(nx, p, f"{pre}.to_out.0", nx.heads_attention(q, k, v, heads))


def _transformer(nx, p, pre, x, context, heads, groups):
    b, c, h, w = x.shape
    y = group_norm(p, f"{pre}.norm", x, groups, eps=1e-6)
    y = conv(nx, p, f"{pre}.proj_in", y, padding=0).permute(0, 2, 3, 1).reshape(b, h * w, c)
    tb = f"{pre}.transformer_blocks.0"
    n1 = layer_norm(p, f"{tb}.norm1", y)
    y = y + _attention(nx, p, f"{tb}.attn1", n1, n1, heads)
    y = y + _attention(nx, p, f"{tb}.attn2", layer_norm(p, f"{tb}.norm2", y), context, heads)
    hidden, gate = lin(nx, p, f"{tb}.ff.net.0.proj", layer_norm(p, f"{tb}.norm3", y)).chunk(2, -1)
    y = y + lin(nx, p, f"{tb}.ff.net.2", hidden * F.gelu(gate))
    y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
    return conv(nx, p, f"{pre}.proj_out", y, padding=0) + x


def unet_forward(p: dict, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                 cfg: dict, nx: Numerics) -> torch.Tensor:
    """x (B, C_in, H, W), timesteps (B,), context (B, L, cross_attention_dim)
    -> the prediction (B, C_out, H, W)."""
    g = cfg["norm_num_groups"]
    ch = cfg["block_out_channels"]
    t = sinusoidal(timesteps, ch[0], cfg["flip_sin_to_cos"], cfg["freq_shift"])
    temb = lin(nx, p, "time_embedding.linear_2",
               F.silu(lin(nx, p, "time_embedding.linear_1", t)))
    h = conv(nx, p, "conv_in", x)
    skips = [h]
    for i, kind in enumerate(cfg["down_block_types"]):
        for j in range(cfg["layers_per_block"]):
            h = _resnet(nx, p, f"down_blocks.{i}.resnets.{j}", h, temb, g)
            if kind == "CrossAttnDownBlock2D":
                h = _transformer(nx, p, f"down_blocks.{i}.attentions.{j}", h, context,
                                 _heads(cfg, i), g)
            skips.append(h)
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in p:
            h = conv(nx, p, f"down_blocks.{i}.downsamplers.0.conv", h, stride=2)
            skips.append(h)
    h = _resnet(nx, p, "mid_block.resnets.0", h, temb, g)
    h = _transformer(nx, p, "mid_block.attentions.0", h, context, _heads(cfg, len(ch) - 1), g)
    h = _resnet(nx, p, "mid_block.resnets.1", h, temb, g)
    n_up = len(cfg["up_block_types"])
    for i, kind in enumerate(cfg["up_block_types"]):
        for j in range(cfg["layers_per_block"] + 1):
            h = _resnet(nx, p, f"up_blocks.{i}.resnets.{j}", torch.cat([h, skips.pop()], 1),
                        temb, g)
            if kind == "CrossAttnUpBlock2D":
                h = _transformer(nx, p, f"up_blocks.{i}.attentions.{j}", h, context,
                                 _heads(cfg, n_up - 1 - i), g)
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in p:
            h = conv(nx, p, f"up_blocks.{i}.upsamplers.0.conv",
                     F.interpolate(h, scale_factor=2.0, mode="nearest"))
    return conv(nx, p, "conv_out", F.silu(group_norm(p, "conv_norm_out", h, g)))


def unet_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The parameter names and shapes of the UNet of ``cfg``."""
    s: dict[str, tuple[int, ...]] = {}
    ch = cfg["block_out_channels"]
    temb, ctx = 4 * ch[0], cfg["cross_attention_dim"]

    def norm(pre, c):
        s.update({f"{pre}.weight": (c,), f"{pre}.bias": (c,)})

    def linear(pre, cin, cout, bias=True):
        s[f"{pre}.weight"] = (cout, cin)
        if bias:
            s[f"{pre}.bias"] = (cout,)

    def conv_(pre, cin, cout, k=3):
        s.update({f"{pre}.weight": (cout, cin, k, k), f"{pre}.bias": (cout,)})

    def resnet(pre, cin, cout):
        norm(f"{pre}.norm1", cin)
        conv_(f"{pre}.conv1", cin, cout)
        linear(f"{pre}.time_emb_proj", temb, cout)
        norm(f"{pre}.norm2", cout)
        conv_(f"{pre}.conv2", cout, cout)
        if cin != cout:
            conv_(f"{pre}.conv_shortcut", cin, cout, k=1)

    def transformer(pre, c):
        norm(f"{pre}.norm", c)
        conv_(f"{pre}.proj_in", c, c, k=1)
        tb = f"{pre}.transformer_blocks.0"
        for n in ("norm1", "norm2", "norm3"):
            norm(f"{tb}.{n}", c)
        for a, kv in (("attn1", c), ("attn2", ctx)):
            linear(f"{tb}.{a}.to_q", c, c, bias=False)
            linear(f"{tb}.{a}.to_k", kv, c, bias=False)
            linear(f"{tb}.{a}.to_v", kv, c, bias=False)
            linear(f"{tb}.{a}.to_out.0", c, c)
        linear(f"{tb}.ff.net.0.proj", c, 8 * c)
        linear(f"{tb}.ff.net.2", 4 * c, c)
        conv_(f"{pre}.proj_out", c, c, k=1)

    linear("time_embedding.linear_1", ch[0], temb)
    linear("time_embedding.linear_2", temb, temb)
    conv_("conv_in", cfg["in_channels"], ch[0])
    out, skips = ch[0], [ch[0]]
    for i, kind in enumerate(cfg["down_block_types"]):
        cin, out = out, ch[i]
        for j in range(cfg["layers_per_block"]):
            resnet(f"down_blocks.{i}.resnets.{j}", cin if j == 0 else out, out)
            if kind == "CrossAttnDownBlock2D":
                transformer(f"down_blocks.{i}.attentions.{j}", out)
            skips.append(out)
        if i != len(ch) - 1:
            conv_(f"down_blocks.{i}.downsamplers.0.conv", out, out)
            skips.append(out)
    resnet("mid_block.resnets.0", ch[-1], ch[-1])
    transformer("mid_block.attentions.0", ch[-1])
    resnet("mid_block.resnets.1", ch[-1], ch[-1])
    prev = ch[-1]
    for i, kind in enumerate(cfg["up_block_types"]):
        out = ch[len(ch) - 1 - i]
        for j in range(cfg["layers_per_block"] + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", (prev if j == 0 else out) + skips.pop(), out)
            if kind == "CrossAttnUpBlock2D":
                transformer(f"up_blocks.{i}.attentions.{j}", out)
        if i != len(ch) - 1:
            conv_(f"up_blocks.{i}.upsamplers.0.conv", out, out)
        prev = out
    norm("conv_norm_out", ch[0])
    conv_("conv_out", ch[0], cfg["out_channels"])
    return s
