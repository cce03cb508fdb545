"""AutoencoderKL (SD1.x VAE) encoder and decoder over a flat param dict
(port of ``scal_sdt_tpu/models/vae.py``), NCHW activations.

Equivalent of the diffusers ``AutoencoderKL`` the reference uses: encode for
latents in the training step and in the offline cache, decode for sampling.
Parameter keys are
the diffusers state-dict names; ``vae_param_shapes`` covers the whole VAE
(encoder and decoder), which the loader validates a checkpoint against.

The mid-block attention is single-head with D = 512: it takes the math path
of ``ops/attention.py``, as it takes XLA's on the TPU. Norms use eps 1e-6
with fp32 statistics. Downsampling pads (0, 1) on H and W and runs a
stride-2 valid conv, as diffusers does; a symmetric ``padding=1`` would be
another function. Upsampling repeats each pixel 2x2 (nearest) before its
conv, as the JAX decoder's broadcast and reshape do in NHWC.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from .functional import Params, conv2d, group_norm, init_params, linear, scaled, silu, sub_params


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    # SD3-family VAEs subtract a latent mean before scaling:
    # z = (z - shift_factor) * scaling_factor (diffusers AutoencoderKL).
    shift_factor: float = 0.0
    # SD3's 16-channel VAE drops the 1x1 quant convs (diffusers
    # use_quant_conv / use_post_quant_conv).
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True

    @classmethod
    def sd15(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)

    @classmethod
    def from_ldm_config(cls, ldm_config) -> "VAEConfig":
        """The first stage of a CompVis LDM architecture YAML."""
        dd = ldm_config.model.params.first_stage_config.params.ddconfig
        return cls(
            in_channels=int(dd.in_channels),
            out_channels=int(dd.out_ch),
            latent_channels=int(dd.z_channels),
            block_out_channels=tuple(int(dd.ch) * m for m in dd.ch_mult),
            layers_per_block=int(dd.num_res_blocks),
            # LDM VAEs are always GroupNorm(32); num_groups is an extension
            # so tiny fixtures round-trip through LDM YAMLs
            norm_num_groups=int(dd.get("num_groups", 32)),
        )


def _resnet(p: Params, pre: str, x: torch.Tensor, groups: int) -> torch.Tensor:
    h = silu(group_norm(p, f"{pre}.norm1", x, groups, eps=1e-6))
    h = conv2d(p, f"{pre}.conv1", h)
    h = silu(group_norm(p, f"{pre}.norm2", h, groups, eps=1e-6))
    h = conv2d(p, f"{pre}.conv2", h)
    if f"{pre}.conv_shortcut.weight" in p:
        x = conv2d(p, f"{pre}.conv_shortcut", x, padding=0)
    return x + h


def _attn(p: Params, pre: str, x: torch.Tensor, groups: int) -> torch.Tensor:
    b, c, h, w = x.shape
    y = group_norm(p, f"{pre}.group_norm", x, groups, eps=1e-6)
    y = y.reshape(b, c, h * w).transpose(1, 2)
    q = linear(p, f"{pre}.to_q", y)
    k = linear(p, f"{pre}.to_k", y)
    v = linear(p, f"{pre}.to_v", y)
    out = multi_head_attention(q, k, v, num_heads=1, scale=float(c) ** -0.5)
    out = linear(p, f"{pre}.to_out.0", out)
    return x + out.transpose(1, 2).reshape(b, c, h, w)


def _mid(p: Params, pre: str, x: torch.Tensor, groups: int) -> torch.Tensor:
    x = _resnet(p, f"{pre}.resnets.0", x, groups)
    x = _attn(p, f"{pre}.attentions.0", x, groups)
    return _resnet(p, f"{pre}.resnets.1", x, groups)


def encoder_apply(params: Params, images: torch.Tensor, config: VAEConfig) -> torch.Tensor:
    """images: (B, 3, H, W) in [-1, 1] -> moments (B, 2*latent, H/8, W/8)."""
    p = sub_params(params, "encoder")
    g = config.norm_num_groups
    h = conv2d(p, "conv_in", images)
    for i in range(len(config.block_out_channels)):
        for j in range(config.layers_per_block):
            h = _resnet(p, f"down_blocks.{i}.resnets.{j}", h, g)
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in p:
            # diffusers VAE downsample: asymmetric (0, 1) pad + stride-2 valid conv
            h = F.pad(h, (0, 1, 0, 1))
            h = conv2d(p, f"down_blocks.{i}.downsamplers.0.conv", h, stride=2, padding=0)
    h = _mid(p, "mid_block", h, g)
    h = silu(group_norm(p, "conv_norm_out", h, g, eps=1e-6))
    h = conv2d(p, "conv_out", h)
    if "quant_conv.weight" in params:
        h = conv2d(params, "quant_conv", h, padding=0)
    return h


def latent_noise(moments: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The normal draw ``sample_latents`` takes: shaped like the mean half of
    ``moments``, in its dtype."""
    b, c2, h, w = moments.shape
    return torch.randn(b, c2 // 2, h, w, generator=generator, dtype=moments.dtype,
                       device=moments.device)


def sample_latents(moments: torch.Tensor, noise: torch.Tensor,
                   scaling_factor: float = 0.18215, shift_factor: float = 0.0) -> torch.Tensor:
    """A sample of the diagonal Gaussian, shifted and scaled as SD latents
    (the reference's ``.latent_dist.sample() * 0.18215``). ``noise`` is the
    standard normal draw, shaped like the mean; the caller draws it
    (``latent_noise``) or injects it."""
    mean, logvar = moments.chunk(2, dim=1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    std = torch.exp(scaled(logvar, 0.5))
    z = mean + std * noise.to(mean.dtype)
    if shift_factor:
        z = z - z.new_full((), shift_factor)
    return scaled(z, scaling_factor)


def decoder_apply(params: Params, latents: torch.Tensor, config: VAEConfig) -> torch.Tensor:
    """latents: (B, latent, h, w), already divided by the scaling factor ->
    images (B, 3, 8h, 8w) in about [-1, 1]."""
    z = (conv2d(params, "post_quant_conv", latents, padding=0)
         if "post_quant_conv.weight" in params else latents)
    p = sub_params(params, "decoder")
    g = config.norm_num_groups
    h = conv2d(p, "conv_in", z)
    h = _mid(p, "mid_block", h, g)
    for i in range(len(config.block_out_channels)):
        for j in range(config.layers_per_block + 1):
            h = _resnet(p, f"up_blocks.{i}.resnets.{j}", h, g)
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in p:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = conv2d(p, f"up_blocks.{i}.upsamplers.0.conv", h)
    h = silu(group_norm(p, "conv_norm_out", h, g, eps=1e-6))
    return conv2d(p, "conv_out", h)


# ---------------------------------------------------------------------------
# Parameter shape template + init
# ---------------------------------------------------------------------------

def _norm_s(pre, c):
    return {f"{pre}.weight": (c,), f"{pre}.bias": (c,)}


def _conv_s(pre, cin, cout, k=3):
    return {f"{pre}.weight": (cout, cin, k, k), f"{pre}.bias": (cout,)}


def _lin_s(pre, cin, cout):
    return {f"{pre}.weight": (cout, cin), f"{pre}.bias": (cout,)}


def _resnet_s(pre, cin, cout):
    s = {}
    s.update(_norm_s(f"{pre}.norm1", cin))
    s.update(_conv_s(f"{pre}.conv1", cin, cout))
    s.update(_norm_s(f"{pre}.norm2", cout))
    s.update(_conv_s(f"{pre}.conv2", cout, cout))
    if cin != cout:
        s.update(_conv_s(f"{pre}.conv_shortcut", cin, cout, k=1))
    return s


def _mid_s(pre, c):
    s = {}
    s.update(_resnet_s(f"{pre}.resnets.0", c, c))
    s.update(_norm_s(f"{pre}.attentions.0.group_norm", c))
    for proj in ("to_q", "to_k", "to_v", "to_out.0"):
        s.update(_lin_s(f"{pre}.attentions.0.{proj}", c, c))
    s.update(_resnet_s(f"{pre}.resnets.1", c, c))
    return s


def vae_param_shapes(config: VAEConfig) -> dict[str, tuple[int, ...]]:
    s: dict[str, tuple[int, ...]] = {}
    ch = config.block_out_channels
    z = config.latent_channels

    # Encoder
    s.update(_conv_s("encoder.conv_in", config.in_channels, ch[0]))
    c = ch[0]
    for i in range(len(ch)):
        for j in range(config.layers_per_block):
            s.update(_resnet_s(f"encoder.down_blocks.{i}.resnets.{j}",
                               c if j == 0 else ch[i], ch[i]))
        c = ch[i]
        if i != len(ch) - 1:
            s.update(_conv_s(f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c))
    s.update(_mid_s("encoder.mid_block", ch[-1]))
    s.update(_norm_s("encoder.conv_norm_out", ch[-1]))
    s.update(_conv_s("encoder.conv_out", ch[-1], 2 * z))
    if config.use_quant_conv:
        s.update(_conv_s("quant_conv", 2 * z, 2 * z, k=1))

    # Decoder
    if config.use_post_quant_conv:
        s.update(_conv_s("post_quant_conv", z, z, k=1))
    s.update(_conv_s("decoder.conv_in", z, ch[-1]))
    s.update(_mid_s("decoder.mid_block", ch[-1]))
    rev = list(reversed(ch))
    c = rev[0]
    for i in range(len(rev)):
        for j in range(config.layers_per_block + 1):
            s.update(_resnet_s(f"decoder.up_blocks.{i}.resnets.{j}",
                               c if j == 0 else rev[i], rev[i]))
        c = rev[i]
        if i != len(rev) - 1:
            s.update(_conv_s(f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c))
    s.update(_norm_s("decoder.conv_norm_out", rev[-1]))
    s.update(_conv_s("decoder.conv_out", rev[-1], config.out_channels))
    return s


def init_vae_params(config: VAEConfig, seed: int = 0, device="cuda",
                    dtype: torch.dtype = torch.float32) -> Params:
    return init_params(vae_param_shapes(config), seed, device, dtype)
