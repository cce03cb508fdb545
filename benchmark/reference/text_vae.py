"""Plain references of the CLIP text tower (transformers' ``CLIPTextModel``)
and of the KL-f8 VAE's decoder (diffusers' ``AutoencoderKL``), float32.

CLIP (``text_encoder/config.json``): token plus position embeddings, then
``num_hidden_layers`` pre-LN layers of causal self-attention and a
quick-GELU MLP, then the final LayerNorm; SD 1.x conditions on the last
layer's states. The VAE decoder (``vae/config.json``): the 1x1
``post_quant_conv``, conv in, a mid block (resnet, single-head attention over
all positions, resnet), then per level ``layers_per_block + 1`` resnets and a
nearest x2 upsample, GroupNorm (eps 1e-6) everywhere, SiLU, conv out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .numerics import Numerics, conv, group_norm, layer_norm, lin


def clip_forward(p: dict, ids: torch.Tensor, cfg: dict, nx: Numerics) -> torch.Tensor:
    """ids (B, L) -> the last hidden states after the final norm (B, L, hidden)."""
    t = "text_model"
    x = (p[f"{t}.embeddings.token_embedding.weight"][ids]
         + p[f"{t}.embeddings.position_embedding.weight"][:ids.shape[1]])
    heads = cfg["num_attention_heads"]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{t}.encoder.layers.{i}"
        n = layer_norm(p, f"{pre}.layer_norm1", x)
        a = nx.heads_attention(lin(nx, p, f"{pre}.self_attn.q_proj", n),
                               lin(nx, p, f"{pre}.self_attn.k_proj", n),
                               lin(nx, p, f"{pre}.self_attn.v_proj", n), heads, causal=True)
        x = x + lin(nx, p, f"{pre}.self_attn.out_proj", a)
        h = lin(nx, p, f"{pre}.mlp.fc1", layer_norm(p, f"{pre}.layer_norm2", x))
        x = x + lin(nx, p, f"{pre}.mlp.fc2", h * torch.sigmoid(1.702 * h))
    return layer_norm(p, f"{t}.final_layer_norm", x)


def clip_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    d, m = cfg["hidden_size"], cfg["intermediate_size"]
    t = "text_model"
    s = {f"{t}.embeddings.token_embedding.weight": (cfg["vocab_size"], d),
         f"{t}.embeddings.position_embedding.weight": (cfg["max_position_embeddings"], d),
         f"{t}.final_layer_norm.weight": (d,), f"{t}.final_layer_norm.bias": (d,)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{t}.encoder.layers.{i}"
        for name, shape in (("layer_norm1", (d,)), ("layer_norm2", (d,))):
            s[f"{pre}.{name}.weight"], s[f"{pre}.{name}.bias"] = shape, shape
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[f"{pre}.self_attn.{proj}.weight"], s[f"{pre}.self_attn.{proj}.bias"] = (d, d), (d,)
        s[f"{pre}.mlp.fc1.weight"], s[f"{pre}.mlp.fc1.bias"] = (m, d), (m,)
        s[f"{pre}.mlp.fc2.weight"], s[f"{pre}.mlp.fc2.bias"] = (d, m), (d,)
    return s


def _resnet(nx, p, pre, x, g):
    h = conv(nx, p, f"{pre}.conv1", F.silu(group_norm(p, f"{pre}.norm1", x, g, 1e-6)))
    h = conv(nx, p, f"{pre}.conv2", F.silu(group_norm(p, f"{pre}.norm2", h, g, 1e-6)))
    if f"{pre}.conv_shortcut.weight" in p:
        x = conv(nx, p, f"{pre}.conv_shortcut", x, padding=0)
    return x + h


def _mid(nx, p, pre, x, g):
    x = _resnet(nx, p, f"{pre}.resnets.0", x, g)
    b, c, h, w = x.shape
    a = f"{pre}.attentions.0"
    y = group_norm(p, f"{a}.group_norm", x, g, 1e-6).reshape(b, c, h * w).transpose(1, 2)
    out = nx.heads_attention(lin(nx, p, f"{a}.to_q", y), lin(nx, p, f"{a}.to_k", y),
                             lin(nx, p, f"{a}.to_v", y), 1)
    x = x + lin(nx, p, f"{a}.to_out.0", out).transpose(1, 2).reshape(b, c, h, w)
    return _resnet(nx, p, f"{pre}.resnets.1", x, g)


def decoder_forward(p: dict, z: torch.Tensor, cfg: dict, nx: Numerics) -> torch.Tensor:
    """z (B, latent, h, w), already divided by the scaling factor -> images
    (B, 3, 8h, 8w), about [-1, 1]."""
    g = cfg["norm_num_groups"]
    h = conv(nx, p, "post_quant_conv", z, padding=0)
    h = _mid(nx, p, "decoder.mid_block", conv(nx, p, "decoder.conv_in", h), g)
    for i in range(len(cfg["block_out_channels"])):
        for j in range(cfg["layers_per_block"] + 1):
            h = _resnet(nx, p, f"decoder.up_blocks.{i}.resnets.{j}", h, g)
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in p:
            h = conv(nx, p, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                     F.interpolate(h, scale_factor=2, mode="nearest"))
    return conv(nx, p, "decoder.conv_out", F.silu(group_norm(p, "decoder.conv_norm_out", h, g,
                                                             1e-6)))


def decoder_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The decoder's (and ``post_quant_conv``'s) names and shapes."""
    s: dict[str, tuple[int, ...]] = {}
    ch, z = list(reversed(cfg["block_out_channels"])), cfg["latent_channels"]

    def norm(pre, c):
        s.update({f"{pre}.weight": (c,), f"{pre}.bias": (c,)})

    def conv_(pre, cin, cout, k=3):
        s.update({f"{pre}.weight": (cout, cin, k, k), f"{pre}.bias": (cout,)})

    def resnet(pre, cin, cout):
        norm(f"{pre}.norm1", cin)
        conv_(f"{pre}.conv1", cin, cout)
        norm(f"{pre}.norm2", cout)
        conv_(f"{pre}.conv2", cout, cout)
        if cin != cout:
            conv_(f"{pre}.conv_shortcut", cin, cout, k=1)

    conv_("post_quant_conv", z, z, k=1)
    conv_("decoder.conv_in", z, ch[0])
    m = "decoder.mid_block"
    resnet(f"{m}.resnets.0", ch[0], ch[0])
    norm(f"{m}.attentions.0.group_norm", ch[0])
    for proj in ("to_q", "to_k", "to_v", "to_out.0"):
        s[f"{m}.attentions.0.{proj}.weight"] = (ch[0], ch[0])
        s[f"{m}.attentions.0.{proj}.bias"] = (ch[0],)
    resnet(f"{m}.resnets.1", ch[0], ch[0])
    c = ch[0]
    for i, out in enumerate(ch):
        for j in range(cfg["layers_per_block"] + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", c if j == 0 else out, out)
        c = out
        if i != len(ch) - 1:
            conv_(f"decoder.up_blocks.{i}.upsamplers.0.conv", out, out)
    norm("decoder.conv_norm_out", ch[-1])
    conv_("decoder.conv_out", ch[-1], cfg["out_channels"])
    return s
