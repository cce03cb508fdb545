"""Shared inputs and checks of the tests that hold the PyTorch port against
the JAX package (tests/test_torch_*.py)."""

import numpy as np
import torch

from scal_sdt_tpu_torch.convert.from_jax import params_from_jax


def rand_unet_params(shapes: dict, seed: int = 0, prefix: str = "") -> dict:
    """Seeded numpy parameters for a shape template: fan-in scaled weights,
    small random biases and norm scales near 1 (so no term is trivially
    zero). Both packages take the same arrays."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(".bias"):
            v = rng.randn(*shape) * 0.02
        elif len(shape) == 1:
            v = 1.0 + rng.randn(*shape) * 0.02
        else:
            v = rng.randn(*shape) / np.sqrt(max(int(np.prod(shape[1:])), 1))
        out[prefix + name] = v.astype(np.float32)
    return out


def to_np(x) -> np.ndarray:
    """numpy of a JAX array or torch tensor; bf16 widens exactly to fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def to_torch(x) -> torch.Tensor:
    """A CPU tensor of a JAX or numpy array, bf16 carried bit for bit."""
    return params_from_jax({"x": np.asarray(x)}, device="cpu")["x"]


def nchw(x) -> torch.Tensor:
    """An fp32 CPU tensor of an (N, H, W, C) JAX or numpy array, as (N, C, H, W)."""
    return torch.from_numpy(np.array(x, np.float32).transpose(0, 3, 1, 2).copy())


def jax_draws(rng, spec, latents_shape):
    """The draws the JAX package's compute_loss makes from `rng` for cached
    latents of (B, h, w, C) ``latents_shape``, NCHW for the port."""
    import jax

    from scal_sdt_tpu_torch.training.step import Draws

    b, h, w, c = latents_shape
    dt = spec.compute_dtype
    _, _, rng_noise, rng_t, _ = jax.random.split(rng, 5)
    noise = jax.random.normal(rng_noise, latents_shape, dtype=dt)
    offset, octaves = None, []
    if spec.noise_offset:
        rng_noise, rng_off = jax.random.split(rng_noise)
        offset = jax.random.normal(rng_off, (b, 1, 1, c), dtype=dt)
    if spec.multires_noise_iterations:
        rng_noise, rng_mn = jax.random.split(rng_noise)
        for i in range(1, spec.multires_noise_iterations + 1):
            hi, wi = max(1, h // 2 ** i), max(1, w // 2 ** i)
            rng_mn, k = jax.random.split(rng_mn)
            octaves.append(jax.random.normal(k, (b, hi, wi, c), dt))
            if hi == 1 and wi == 1:
                break
    # integers from a DDPM schedule, fp32 floats from the flow schedule
    t = np.asarray(spec.schedule.sample_timesteps(rng_t, b))
    t = t.astype(np.int64) if np.issubdtype(t.dtype, np.integer) else t.astype(np.float32)
    return Draws(noise=nchw(noise), timesteps=torch.from_numpy(t),
                 offset=None if offset is None else nchw(offset),
                 octaves=tuple(nchw(o) for o in octaves))


def bf16_ulp(x) -> np.ndarray:
    """The bf16 spacing at |x|: 2^(e-7) for |x| in [2^e, 2^(e+1)), and the
    subnormal spacing 2^-133 below 2^-126."""
    m = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def assert_bf16_ulp(got, want, what: str = "", slack=0.0) -> None:
    """At most one bf16 ulp apart, the ulp of the larger magnitude, plus
    ``slack`` (absolute, per element)."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    bound = bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + slack
    bad = np.abs(got - want) > bound
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} differ by more than 1 ulp"


def tiny_model_dir(path, vocab_size: int = 640, seed: int = 0, scheduler_overrides=None):
    """A tiny SD1.x diffusers directory (tests/helpers.py
    ``write_diffusers_dir``) with seeded numpy weights from
    ``rand_unet_params``, which is much faster than initialising the models
    through JAX. The CLIP tower has ``vocab_size`` rows."""
    from scal_sdt_tpu.convert.loader import LoadedModels
    from scal_sdt_tpu.diffusion.schedule import NoiseSchedule
    from scal_sdt_tpu.models.clip import CLIPTextConfig, clip_param_shapes
    from scal_sdt_tpu.models.unet import UNetConfig, unet_param_shapes
    from scal_sdt_tpu.models.vae import VAEConfig, vae_param_shapes

    from helpers import write_diffusers_dir

    unet, vae = UNetConfig.tiny(), VAEConfig.tiny()
    clip = CLIPTextConfig(vocab_size=vocab_size, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=2)
    models = LoadedModels(
        unet=rand_unet_params(unet_param_shapes(unet), seed), unet_config=unet,
        vae=rand_unet_params(vae_param_shapes(vae), seed + 1), vae_config=vae,
        clip=rand_unet_params(clip_param_shapes(clip), seed + 2), clip_config=clip,
        schedule=NoiseSchedule())
    return write_diffusers_dir(models, path, scheduler_overrides)


def tiny_sdxl_models(vocab_size: int = 640, seed: int = 0):
    """The JAX package's tiny SDXL models (the configs of tests/helpers.py
    ``tiny_sdxl_models``: a text_time UNet, two 32-wide towers, tower 2 with
    a 32-wide projection) with seeded numpy weights from
    ``rand_unet_params``, as JAX ``LoadedModels``."""
    from scal_sdt_tpu.convert.loader import LoadedModels
    from scal_sdt_tpu.diffusion.schedule import NoiseSchedule
    from scal_sdt_tpu.models.clip import CLIPTextConfig, clip_param_shapes
    from scal_sdt_tpu.models.unet import UNetConfig, unet_param_shapes
    from scal_sdt_tpu.models.vae import VAEConfig, vae_param_shapes

    unet, vae = UNetConfig.tiny_sdxl(), VAEConfig.tiny()
    clip = CLIPTextConfig(vocab_size=vocab_size, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=2)
    clip2 = CLIPTextConfig(vocab_size=vocab_size, hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=2, hidden_act="gelu",
                           projection_dim=32)
    return LoadedModels(
        unet=rand_unet_params(unet_param_shapes(unet), seed), unet_config=unet,
        vae=rand_unet_params(vae_param_shapes(vae), seed + 1), vae_config=vae,
        clip=rand_unet_params(clip_param_shapes(clip), seed + 2), clip_config=clip,
        schedule=NoiseSchedule(),
        clip2=rand_unet_params(clip_param_shapes(clip2), seed + 3), clip2_config=clip2)


def tiny_sdxl_dir(path, vocab_size: int = 640, seed: int = 0):
    """``tiny_sdxl_models`` as a diffusers directory (tests/helpers.py
    ``write_diffusers_dir``: ``text_encoder_2/`` with its projection)."""
    from helpers import write_diffusers_dir

    return write_diffusers_dir(tiny_sdxl_models(vocab_size, seed), path)


def tiny_sd3_dir(path, models=None, with_t5: bool = True):
    """The JAX package's tiny SD3 models (``models``, default tests/helpers.py
    ``tiny_sd3_models`` with 640 token rows: an MMDiT, two projected CLIP
    towers, T5) as a diffusers directory, T5 left out without ``with_t5``,
    with a T5 tokenizer (``make_t5_tokenizer_file``) in ``tokenizer_3/``
    beside T5. Returns (the directory, the JAX ``LoadedModels`` written)."""
    import dataclasses

    from helpers import make_t5_tokenizer_file, tiny_sd3_models, write_diffusers_dir

    models = models if models is not None else tiny_sd3_models(vocab_size=640)
    if not with_t5:
        models = dataclasses.replace(models, t5=None, t5_config=None)
    d = write_diffusers_dir(models, path)
    if with_t5:
        make_t5_tokenizer_file(d / "tokenizer_3" / "tokenizer.json")
    return d, models
