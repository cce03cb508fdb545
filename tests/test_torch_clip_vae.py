"""The port's CLIP text encoder, VAE encoder and decoder and diffusers
loader against the JAX package, in fp32 on the CPU (the decoder in bf16 too).

Same seeded numpy params and inputs into both; outputs within 1e-5 of the
reference's largest entry (the two sum products in another order): CLIP at
``stop_at_layer`` 1 and 2, the VAE moments and decoded images (NCHW here,
NHWC in JAX), ``sample_latents`` with the noise injected. Shape templates, EOS positions,
``quick_gelu`` and the loader's configs and dicts agree exactly.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scal_sdt_tpu.convert import loader as jloader
from scal_sdt_tpu.convert.sd_names import normalize_df_vae_attention as jnormalize
from scal_sdt_tpu.models import clip as jclip
from scal_sdt_tpu.models import functional as jF
from scal_sdt_tpu.models import vae as jvae

from scal_sdt_tpu_torch.convert import loader as tloader
from scal_sdt_tpu_torch.convert.from_jax import params_from_jax
from scal_sdt_tpu_torch.convert.sd_names import normalize_df_vae_attention as tnormalize
from scal_sdt_tpu_torch.models import clip as tclip
from scal_sdt_tpu_torch.models import functional as tF
from scal_sdt_tpu_torch.models import vae as tvae

from torch_port_helpers import rand_unet_params, tiny_model_dir, tiny_sdxl_dir, to_np

TOL = 1e-5   # max-abs error, relative to the reference's largest entry
DECODER_BF16_TOL = 2.0 ** -5


def _close(got, want, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, f"{what}: {err}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("name", ["vit_l", "sd21", "tiny"])
def test_clip_config_and_shapes_match_jax(name):
    jc, tc = getattr(jclip.CLIPTextConfig, name)(), getattr(tclip.CLIPTextConfig, name)()
    assert jc.__dict__ == tc.__dict__
    assert tclip.clip_param_shapes(tc) == jclip.clip_param_shapes(jc)


@pytest.mark.parametrize("name", ["sd15", "tiny"])
def test_vae_config_and_shapes_match_jax(name):
    jc, tc = getattr(jvae.VAEConfig, name)(), getattr(tvae.VAEConfig, name)()
    assert jc.__dict__ == tc.__dict__
    assert tvae.vae_param_shapes(tc) == jvae.vae_param_shapes(jc)


def test_quick_gelu_matches_jax():
    x = np.random.RandomState(0).randn(4, 33).astype(np.float32) * 3
    _close(tF.quick_gelu(torch.from_numpy(x)), jF.quick_gelu(jnp.asarray(x)))


@pytest.mark.parametrize("stop_at_layer", [1, 2])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_text_apply_matches_jax(stop_at_layer, act):
    import dataclasses

    jc = dataclasses.replace(jclip.CLIPTextConfig.tiny(), hidden_act=act)
    tc = dataclasses.replace(tclip.CLIPTextConfig.tiny(), hidden_act=act)
    params = rand_unet_params(jclip.clip_param_shapes(jc), seed=1)
    r = np.random.RandomState(2)
    ids = r.randint(0, jc.vocab_size, (3, 77)).astype(np.int32)
    want = jclip.clip_text_apply({k: jnp.asarray(v) for k, v in params.items()},
                                 jnp.asarray(ids), jc, stop_at_layer)
    got = tclip.clip_text_apply(params_from_jax(params, device="cpu"), torch.from_numpy(ids),
                                tc, stop_at_layer)
    _close(got, want, f"clip stop_at_layer={stop_at_layer}")


@pytest.mark.parametrize("eos", [49407, 2])
def test_eos_positions_match_jax(eos):
    r = np.random.RandomState(eos)
    ids = r.randint(0, 4000, (5, 12)).astype(np.int32)
    ids[0, 3:] = 49407          # padded with EOS: the first one counts
    ids[1, 5] = 49407
    ids[3, :] = 7               # no EOS at all
    np.testing.assert_array_equal(tclip.eos_positions(torch.from_numpy(ids), eos).numpy(),
                                  np.asarray(jclip.eos_positions(jnp.asarray(ids), eos)))


def test_clip_refuses_textual_inversion_rows():
    """Textual-inversion rows were refused until the port trained them; now
    ``trained_extra`` extends the table: an id past it reads those rows (as
    in JAX; tests/test_torch_ti.py holds the encoder against JAX's). The
    name dates from the refusal and is kept, so that the test's ID stays the
    same."""
    params = params_from_jax(rand_unet_params(
        jclip.clip_param_shapes(jclip.CLIPTextConfig.tiny())), device="cpu")
    cfg = tclip.CLIPTextConfig.tiny()
    ids = torch.zeros(1, 77, dtype=torch.long)
    base = tclip.clip_text_apply(params, ids, cfg)
    params[tclip.TRAINED_EXTRA] = torch.ones(2, 32)
    assert torch.equal(tclip.clip_text_apply(params, ids, cfg), base)
    ids[0, 3] = cfg.vocab_size + 1
    assert not torch.equal(tclip.clip_text_apply(params, ids, cfg), base)


@pytest.fixture(scope="module")
def tiny_vae():
    params = rand_unet_params(jvae.vae_param_shapes(jvae.VAEConfig.tiny()), seed=3)
    images = np.random.RandomState(4).uniform(-1, 1, (2, 20, 18, 3)).astype(np.float32)
    return params, images


def test_encoder_apply_matches_jax(tiny_vae):
    """Odd sizes (20 x 18 -> 10 x 9), so the (0, 1) downsampling pad shows."""
    params, images = tiny_vae
    want = jvae.encoder_apply({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(images), jvae.VAEConfig.tiny())
    got = tvae.encoder_apply(params_from_jax(params, device="cpu"), _nchw(images),
                             tvae.VAEConfig.tiny())
    assert got.shape == (2, 8, 10, 9)
    _close(got.permute(0, 2, 3, 1), want, "moments")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("post_quant_conv", [True, False])
def test_decoder_apply_matches_jax(tiny_vae, dtype, post_quant_conv):
    """Latents (2, 4, 9, 7) -> images (2, 3, 18, 14). fp32 within TOL of the
    reference's largest entry; bf16 within DECODER_BF16_TOL (2^-5, four bf16
    ulps of it: each package rounds its bf16 chain at other points)."""
    params, _ = tiny_vae
    if not post_quant_conv:
        params = {k: v for k, v in params.items() if not k.startswith("post_quant_conv.")}
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    latents = np.random.RandomState(8).randn(2, 9, 7, 4).astype(np.float32) * 3
    jparams = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    want = jvae.decoder_apply(jparams, jnp.asarray(latents, jdt), jvae.VAEConfig.tiny())
    tparams = {k: v.to(tdt) for k, v in params_from_jax(params, device="cpu").items()}
    got = tvae.decoder_apply(tparams, _nchw(latents).to(tdt), tvae.VAEConfig.tiny())
    assert got.shape == (2, 3, 18, 14) and got.dtype == tdt
    got, want = to_np(got.permute(0, 2, 3, 1)), to_np(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= (TOL if dtype == "float32" else DECODER_BF16_TOL), f"{dtype}: {err}"


def test_decoder_upsample_equals_pixel_repeat():
    """The decoder's nearest x2 upsample is the JAX decoder's broadcast and
    reshape: every pixel repeated 2 x 2, bit for bit."""
    x = torch.randn(2, 3, 5, 7).to(torch.bfloat16)
    up = torch.nn.functional.interpolate(x, scale_factor=2, mode="nearest")
    assert torch.equal(up, x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))
    b, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    assert torch.equal(up, nhwc.reshape(b, 2 * h, 2 * w, c).permute(0, 3, 1, 2))


@pytest.mark.parametrize("shift", [0.0, 0.0609])
def test_sample_latents_matches_jax(shift):
    """The JAX draw injected as the noise; logvar spans the clip range."""
    r = np.random.RandomState(5)
    moments = r.randn(2, 5, 6, 8).astype(np.float32) * 4
    moments[..., 4:] *= 10     # logvar beyond [-30, 20] gets clipped
    rng = jax.random.PRNGKey(9)
    want = jvae.sample_latents(jnp.asarray(moments), rng, 0.18215, shift)
    noise = jax.random.normal(rng, (2, 5, 6, 4), jnp.float32)
    got = tvae.sample_latents(_nchw(moments), _nchw(noise), 0.18215, shift)
    _close(got.permute(0, 2, 3, 1), want, "latents")
    assert tvae.latent_noise(_nchw(moments), torch.Generator().manual_seed(0)).shape == (2, 4,
                                                                                         5, 6)


def test_normalize_df_vae_attention_matches_jax():
    r = np.random.RandomState(6)
    state = {"encoder.mid_block.attentions.0.query.weight": r.randn(8, 8, 1, 1),
             "encoder.mid_block.attentions.0.proj_attn.bias": r.randn(8),
             "encoder.mid_block.attentions.0.key.weight": r.randn(8, 8),
             "encoder.conv_in.weight": r.randn(8, 3, 3, 3)}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    want = jnormalize(state)
    got = tnormalize(params_from_jax(state, device="cpu"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]))


def test_load_diffusers_dir_matches_jax(tmp_path):
    """The loader's configs, schedule and dicts agree with the JAX loader's
    on a tiny diffusers directory; a schedule override applies."""
    d = tiny_model_dir(tmp_path / "model", scheduler_overrides={"prediction_type":
                                                                 "v_prediction"})
    jm, tm = jloader.load_diffusers_dir(d), tloader.load_diffusers_dir(d)
    for what in ("unet", "vae", "clip"):
        assert getattr(tm, f"{what}_config").__dict__ == getattr(jm, f"{what}_config").__dict__
        got, want = getattr(tm, what), getattr(jm, what)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert tm.schedule.prediction_type == jm.schedule.prediction_type == "v"
    np.testing.assert_array_equal(tm.schedule.alphas_cumprod, jm.schedule.alphas_cumprod)

    from scal_sdt_tpu_torch import conf as tconf

    cfg = tconf.merge(tconf.default(), tconf.Config({
        "model": str(d), "schedule": {"rescale_zero_terminal_snr": True}}))
    assert tloader.load_components(cfg).schedule.rescale_zero_terminal_snr
    # a file goes to the single-file reader, as in JAX (an empty one is no
    # safetensors file: tests/test_torch_single_file.py loads real ones); a
    # name that is no local path is refused (hub ids need the network)
    (tmp_path / "file.safetensors").write_bytes(b"")
    file_cfg, absent_cfg = (tconf.merge(cfg, tconf.Config({"model": str(tmp_path / name)}))
                            for name in ("file.safetensors", "absent"))
    with pytest.raises(Exception, match="header too small"):
        tloader.load_components(file_cfg)
    with pytest.raises(NotImplementedError, match="hub ids"):
        tloader.load_components(absent_cfg)
    # SDXL's second tower (ROADMAP 1.15): an empty text_encoder_2/ raises as
    # JAX's loader does; a real one loads as JAX loads it
    import shutil

    (d / "text_encoder_2").mkdir()
    for loader in (jloader, tloader):
        with pytest.raises(FileNotFoundError, match="No weights file"):
            loader.load_diffusers_dir(d)
    d.joinpath("text_encoder_2").rmdir()
    shutil.copytree(tiny_sdxl_dir(tmp_path / "sdxl") / "text_encoder_2", d / "text_encoder_2")
    jm, tm = jloader.load_diffusers_dir(d), tloader.load_diffusers_dir(d)
    assert tm.clip2_config.__dict__ == jm.clip2_config.__dict__
    assert tm.clip2_config.projection_dim == 32 and not tm.is_sdxl
    assert tm.clip2.keys() == jm.clip2.keys()
    for k in jm.clip2:
        np.testing.assert_array_equal(to_np(tm.clip2[k]), np.asarray(jm.clip2[k]), err_msg=k)


def test_loader_validates_shapes(tmp_path):
    d = tiny_model_dir(tmp_path / "model")
    cfg = json.loads((d / "vae" / "config.json").read_text())
    cfg["latent_channels"] = 8
    (d / "vae" / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="vae: shape mismatches"):
        tloader.load_diffusers_dir(d)
