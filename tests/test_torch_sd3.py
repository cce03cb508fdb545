"""The port's SD3 slice against the JAX package, on the CPU.

The JAX package's tiny SD3 models (tests/helpers.py ``tiny_sd3_models``: a
2-block MMDiT at head dim 8, two projected 16-wide CLIP towers, a gated T5
of width 32) go through both packages; inputs come from numpy seeds, JAX's
draws are injected. Tolerances:

* configs, shape templates, the sincos table, optim-target resolutions,
  loaded dicts, T5 token ids and relative-position buckets, cache metadata:
  equal;
* the flow schedule: the model timesteps of the same normal draws within
  1e-6 relative, ``add_noise`` within 1e-6 of the largest entry (fp32),
  ``training_target`` equal, the sampling sigmas within 1e-6;
* ``mmdit_apply`` on the tiny config and its ``qk_norm: rms_norm`` and
  ``dual_attention_layers`` variants: fp32 within 1e-5 of the largest
  output (sums in another order), bf16 within 3e-2 of it (the two packages
  round bf16 at other places; about 2% measured, difference (n));
* the T5 encoder, relu and gated (fp32): within 1e-5 of the largest entry;
* ``compute_loss`` in both SD3 branches (cached with ``pooled``; the
  triple-encoder branch with and without T5, CFG dropout 'eos' and 'zeros')
  and its gradients: within 1e-4 relative, fp32;
* ``lora_sd3`` over one train step (AdamW, fp32 masters, no moment dtype):
  the loss within 1e-5 relative, the LoRA masters within 1e-4 of each
  tensor's largest entry in all but 1e-3 of the elements and within
  2 * lr everywhere (``test_torch_sdxl.py``'s bound);
* the cache file: latents, conds and pooled within 1e-5 of their largest
  entry, and each package reads the other's;
* ``flow_euler`` with JAX's draws, the tiny MMDiT over 3 steps: fp32 within
  1e-4 of JAX, bf16 within 2^-3 (difference (n)); ``sample_images`` with T5
  in fp32 within one uint8 level;
* the whole slice through the port's CLIs: ``cli.train`` with ``lora_sd3``
  trains and checkpoints, ``cli.sample`` writes a PNG from the checkpoint.
"""

import json
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

import jax
import jax.numpy as jnp

import scal_sdt_tpu.diffusion.sampler as jsampler
from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.cli import cache as jcache
from scal_sdt_tpu.convert import loader as jloader
from scal_sdt_tpu.data import datasets as jdatasets
from scal_sdt_tpu.diffusion import flow as jflow
from scal_sdt_tpu.models import mmdit as jmmdit
from scal_sdt_tpu.models import t5 as jt5
from scal_sdt_tpu.text import tokenizer as jtok
from scal_sdt_tpu.training import lora as jlora
from scal_sdt_tpu.training import optim_targets as jtargets
from scal_sdt_tpu.training import optimizers as jopt
from scal_sdt_tpu.training import step as jstep
from scal_sdt_tpu.utils import state as jstate

import scal_sdt_tpu_torch.diffusion.sampler as tsampler
from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.cli import cache as tcache
from scal_sdt_tpu_torch.cli import sample as tsample_cli
from scal_sdt_tpu_torch.cli import train as ttrain_cli
from scal_sdt_tpu_torch.convert import loader as tloader
from scal_sdt_tpu_torch.convert.from_jax import params_from_jax
from scal_sdt_tpu_torch.data import datasets as tdatasets
from scal_sdt_tpu_torch.diffusion import flow as tflow
from scal_sdt_tpu_torch.models import clip as tclip
from scal_sdt_tpu_torch.models import mmdit as tmmdit
from scal_sdt_tpu_torch.models import t5 as tt5
from scal_sdt_tpu_torch.models.vae import VAEConfig as TVAEConfig
from scal_sdt_tpu_torch.text import tokenizer as ttok
from scal_sdt_tpu_torch.training import optim_targets as ttargets
from scal_sdt_tpu_torch.training import optimizers as topt
from scal_sdt_tpu_torch.training import step as tstep
from scal_sdt_tpu_torch.utils import state as tstate

from helpers import make_image_dataset, make_t5_tokenizer_file
from test_torch_cache import _jax_latent_noise
from test_torch_data import write_vocab
from torch_port_helpers import jax_draws, nchw, rand_unet_params, tiny_sd3_dir, to_np, to_torch

MMDIT_TOL = 1e-5        # the MMDiT and T5 in fp32, of the largest output
BF16_MMDIT_TOL = 3e-2   # the MMDiT in bf16 (difference (n))
LOSS_TOL = 1e-4         # compute_loss and its gradients, relative
CACHE_TOL = 1e-5        # the cache file's tensors, of the largest entry
SAMPLE_TOL = 1e-4       # the fp32 flow-Euler loop
BF16_SAMPLE_TOL = 2.0 ** -3
SEQ, T5_SEQ = 77, 16
BATCH, H, W, CFG, STEPS = 2, 16, 16, 5.0, 3


def _rel(a, b) -> float:
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _ids(seed: int, batch: int = BATCH) -> np.ndarray:
    """CLIP prompt ids below the towers' 640 rows: BOS 638, words, EOS 639
    and EOS padding."""
    r = np.random.RandomState(seed)
    ids = np.full((batch, SEQ), 639, np.int32)
    for b in range(batch):
        n = r.randint(3, 12)
        ids[b, 0] = 638
        ids[b, 1:n + 1] = r.randint(0, 600, n)
    return ids


def _t5_ids(seed: int, batch: int = BATCH) -> np.ndarray:
    """T5 ids: words, EOS 1, then pad 0."""
    r = np.random.RandomState(seed)
    ids = np.zeros((batch, T5_SEQ), np.int32)
    for b in range(batch):
        n = r.randint(2, 9)
        ids[b, :n] = r.randint(3, 600, n)
        ids[b, n] = 1
    return ids


@pytest.fixture(scope="module")
def models():
    from helpers import tiny_sd3_models

    return tiny_sd3_models(vocab_size=640)


def _tconfigs(m):
    """The port's (MMDiT, CLIP, CLIP-2, T5 or None) configs of the JAX
    ``LoadedModels`` ``m``."""
    return (tmmdit.MMDiTConfig(**m.mmdit_config.__dict__),
            tclip.CLIPTextConfig(**m.clip_config.__dict__),
            tclip.CLIPTextConfig(**m.clip2_config.__dict__),
            tt5.T5Config(**m.t5_config.__dict__) if m.t5_config is not None else None)


# --- the flow schedule -----------------------------------------------------------------

def test_flow_schedule_matches_jax():
    js = jflow.FlowSchedule.from_diffusers_scheduler_config({"shift": 3.0,
                                                             "num_train_timesteps": 1000})
    ts = tflow.FlowSchedule.from_diffusers_scheduler_config({"shift": 3.0,
                                                             "num_train_timesteps": 1000})
    assert ts.__dict__ == js.__dict__ and ts.prediction_type == "flow"
    key = jax.random.PRNGKey(4)
    z = jax.random.normal(key, (64,), jnp.float32)
    want = np.asarray(js.sample_timesteps(key, 64))
    got = ts.timesteps_of(torch.from_numpy(np.array(z)))
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-6
    assert 0.0 < want.min() and want.max() < 1000.0

    r = np.random.RandomState(0)
    x0, noise = (r.randn(4, 6, 6, 3).astype(np.float32) for _ in range(2))
    t = np.array(want[:4])
    jx = js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    tx = ts.add_noise(nchw(x0), nchw(noise), torch.from_numpy(t))
    assert _rel(tx, nchw(jx)) <= 1e-6
    np.testing.assert_array_equal(
        to_np(ts.training_target(nchw(x0), nchw(noise), torch.from_numpy(t))),
        to_np(nchw(js.training_target(jnp.asarray(x0), jnp.asarray(noise), None))))
    assert _rel(ts.sampling_sigmas(28), js.sampling_sigmas(28)) <= 1e-6
    assert float(ts.sampling_sigmas(28)[0]) == 1.0 and float(ts.sampling_sigmas(28)[-1]) == 0.0
    for schedule, arr in ((ts, torch.zeros(2)), (js, jnp.zeros(2))):
        with pytest.raises(NotImplementedError, match="min_snr_gamma"):
            schedule.min_snr_weight(arr, 5.0)


# --- the MMDiT and T5 --------------------------------------------------------------------

def _variant(name: str) -> jmmdit.MMDiTConfig:
    base = jmmdit.MMDiTConfig.tiny().__dict__
    return jmmdit.MMDiTConfig(**{**base, **{
        "tiny": {}, "qk_norm": {"qk_norm": "rms_norm"},
        "dual": {"qk_norm": "rms_norm", "dual_attention_layers": (0,)}}[name]})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["tiny", "qk_norm", "dual"])
def test_mmdit_matches_jax(variant, dtype, monkeypatch):
    """mmdit_apply on NCHW latents against JAX's on NHWC (an 8x6 latent grid,
    so the token order of patchify and unpatchify shows): every block's
    joint attention runs through ops.attention over latent tokens then
    context tokens, the dual block's attn2 over the latent tokens."""
    jc = _variant(variant)
    tc = tmmdit.MMDiTConfig(**jc.__dict__)
    assert tc == tmmdit.MMDiTConfig.from_json({**jc.__dict__,
                                               "dual_attention_layers": list(
                                                   jc.dual_attention_layers)})
    shapes = jmmdit.mmdit_param_shapes(jc)
    assert tmmdit.mmdit_param_shapes(tc) == shapes
    table = jmmdit.sincos_pos_embed_2d(jc.inner_dim, jc.pos_embed_max_size)
    np.testing.assert_array_equal(to_np(tmmdit.sincos_pos_embed_2d(tc.inner_dim,
                                                                   tc.pos_embed_max_size)),
                                  table)
    params = rand_unet_params(shapes, 3)
    params[tmmdit.POS_EMBED_KEY] = table
    r = np.random.RandomState(1)
    lat = r.randn(2, 8, 6, 4).astype(np.float32)
    t = np.array([3.5, 870.25], np.float32)
    ctx = r.randn(2, 5, jc.joint_attention_dim).astype(np.float32)
    pooled = r.randn(2, jc.pooled_projection_dim).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jmmdit.mmdit_apply({k: jnp.asarray(v, jdt) for k, v in params.items()},
                              jnp.asarray(lat, jdt), jnp.asarray(t), jnp.asarray(ctx),
                              jnp.asarray(pooled), jc)
    calls = []
    mha = tmmdit.multi_head_attention
    monkeypatch.setattr(tmmdit, "multi_head_attention",
                        lambda q, k, v, h: calls.append(tuple(q.shape)) or mha(q, k, v, h))
    got = tmmdit.mmdit_apply({k: torch.from_numpy(v).to(tdt) for k, v in params.items()},
                             nchw(lat).to(tdt), torch.from_numpy(t), torch.from_numpy(ctx),
                             torch.from_numpy(pooled), tc)
    assert got.dtype == tdt and got.shape == (2, 4, 8, 6)
    tol = MMDIT_TOL if dtype == "float32" else BF16_MMDIT_TOL
    assert _rel(got, nchw(want)) <= tol, _rel(got, nchw(want))
    d = jc.inner_dim
    want_calls = [(2, 12 + 5, d)] * jc.num_layers
    if jc.dual_attention_layers:
        want_calls.insert(1, (2, 12, d))   # block 0's attn2, after its joint attention
    assert calls == want_calls


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_t5_encoder_matches_jax(ff):
    jc = jt5.T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
                      feed_forward_proj=ff)
    tc = tt5.T5Config(**jc.__dict__)
    assert tc == tt5.T5Config.from_json(jc.__dict__)
    assert tt5.t5_param_shapes(tc) == jt5.t5_param_shapes(jc)
    rel = np.arange(-200, 200)
    np.testing.assert_array_equal(
        to_np(tt5.relative_position_bucket(torch.from_numpy(rel), 32, 128)),
        np.asarray(jt5._relative_position_bucket(jnp.asarray(rel), 32, 128)))
    params = rand_unet_params(jt5.t5_param_shapes(jc), 2)
    ids = np.random.RandomState(3).randint(0, 64, (2, 40)).astype(np.int32)
    want = jt5.t5_encoder_apply({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(ids), jc)
    got = tt5.t5_encoder_apply({k: torch.from_numpy(v) for k, v in params.items()},
                               torch.from_numpy(ids), tc)
    assert got.dtype == torch.float32 and _rel(got, want) <= MMDIT_TOL


def test_t5_tokenizer_matches_jax(tmp_path, monkeypatch):
    """The synthetic T5 tokenizer.json: the same ids (EOS appended, padded
    with 0 to the length); found under <model>/tokenizer_3 or by the
    ``tokenizer_3:`` key; None without a file; an error naming the
    `tokenizers` package when it does not import."""
    f = make_t5_tokenizer_file(tmp_path / "model" / "tokenizer_3" / "tokenizer.json")
    prompts = ["a photo of the cat", "", "dog and cat number 3"]
    want = jtok.T5TokenizerWrapper.from_file(f, max_length=T5_SEQ)(prompts)
    got = ttok.T5TokenizerWrapper.from_file(f, max_length=T5_SEQ)(prompts)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, T5_SEQ) and got.dtype == np.int32 and got[1, 0] == 1
    for cfg in ({"model": str(tmp_path / "model")}, {"tokenizer_3": str(f)}):
        tk = ttok.resolve_t5_tokenizer(tconf.Config({**cfg, "t5_max_length": T5_SEQ}))
        np.testing.assert_array_equal(tk(prompts), want)
    assert ttok.resolve_t5_tokenizer(tconf.Config({"model": str(tmp_path)})) is None
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="`tokenizers` package"):
        ttok.resolve_t5_tokenizer(tconf.Config({"model": str(tmp_path / "model")}))


# --- loader, from_jax --------------------------------------------------------------------

@pytest.fixture(scope="module")
def sd3_dirs(models, tmp_path_factory):
    """The tiny SD3 models as directories with and without T5, each with a
    CLIP vocab in tokenizer/ (and the T5 tokenizer in tokenizer_3/ beside
    T5)."""
    tmp = tmp_path_factory.mktemp("sd3")
    out = {}
    for name, with_t5 in (("t5", True), ("no_t5", False)):
        d, _ = tiny_sd3_dir(tmp / name, models, with_t5=with_t5)
        write_vocab(d / "tokenizer")
        out[name] = d
    return out


@pytest.mark.parametrize("name", ["t5", "no_t5"])
def test_loader_reads_an_sd3_dir_like_jax(sd3_dirs, name, tmp_path):
    """The dicts, configs and flow schedule JAX's loader reads, bit for bit;
    without pos_embed in its file the MMDiT gets the sincos table."""
    import shutil

    d = sd3_dirs[name]
    jm, tm = jloader.load_diffusers_dir(d), tloader.load_diffusers_dir(d)
    assert tm.is_sd3 and not tm.is_sdxl and tm.unet_config is None
    assert tm.mmdit_config.__dict__ == jm.mmdit_config.__dict__
    assert isinstance(tm.schedule, tflow.FlowSchedule)
    assert tm.schedule.__dict__ == jm.schedule.__dict__
    for what in ("vae", "clip", "clip2") + (("t5",) if name == "t5" else ()):
        assert getattr(tm, f"{what}_config").__dict__ == getattr(jm, f"{what}_config").__dict__
    assert (tm.t5 is None) == (name == "no_t5")
    for what in ("unet", "vae", "clip", "clip2") + (("t5",) if name == "t5" else ()):
        got, want = getattr(tm, what), getattr(jm, what)
        assert got.keys() == want.keys(), what
        for k in want:
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert tm.vae_config.latent_channels == tm.mmdit_config.in_channels

    bare = tmp_path / "bare"
    shutil.copytree(d, bare)
    f = bare / "transformer" / "diffusion_pytorch_model.safetensors"
    tensors = tstate.load_state_dict(f)
    del tensors[tmmdit.POS_EMBED_KEY]
    tstate.save_state_dict(tensors, f, "safetensors")
    got = tloader.load_diffusers_dir(bare).unet[tmmdit.POS_EMBED_KEY]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(to_np(got), np.asarray(
        jloader.load_diffusers_dir(bare).unet[tmmdit.POS_EMBED_KEY]))


def test_from_jax_carries_sd3_trees_bit_for_bit(models):
    """The MMDiT and T5 trees in bf16, and the fp32 pos_embed buffer beside
    them, cross as they are."""
    tree = {**{f"unet.{k}": jnp.asarray(v, jnp.float32 if k == tmmdit.POS_EMBED_KEY
                                        else jnp.bfloat16) for k, v in models.unet.items()},
            **{f"t5.{k}": jnp.asarray(v, jnp.bfloat16) for k, v in models.t5.items()}}
    got = params_from_jax(tree, device="cpu")
    for k, v in tree.items():
        want = np.asarray(v)
        assert str(got[k].dtype) == f"torch.{want.dtype.name}", k
        np.testing.assert_array_equal(to_np(got[k]), want.astype(np.float32), err_msg=k)


# --- compute_loss in both SD3 branches ------------------------------------------------------

LOSS_CASES = {
    # (T5 tower, uncond section, trainable components, cached)
    "cached": (True, {}, ("unet",), True),
    "t5-eos-drop": (True, {"enabled": True, "p": 1.0, "cond": "eos"},
                    ("unet", "text_encoder_2"), False),
    "t5-zeros-drop": (True, {"enabled": True, "p": 1.0, "cond": "zeros"},
                      ("unet", "text_encoder"), False),
    "t5-zeros-kept": (True, {"enabled": True, "p": 0.0, "cond": "zeros"},
                      ("text_encoder", "text_encoder_2"), False),
    "no_t5-eos-drop": (False, {"enabled": True, "p": 1.0, "cond": "eos"}, ("unet",), False),
    "no_t5-zeros-kept": (False, {"enabled": True, "p": 0.0, "cond": "zeros"},
                         ("unet", "text_encoder_2"), False),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_sd3_compute_loss_and_grads_match_jax(models, case):
    with_t5, uncond, trained, cached = LOSS_CASES[case]
    params = {}
    comps = [("unet", models.unet), ("text_encoder", models.clip),
             ("text_encoder_2", models.clip2)] + ([("text_encoder_3", models.t5)] if with_t5
                                                   else [])
    for comp, p in comps:
        params.update({f"{jstep.component_prefix(comp)}.{k}": v for k, v in p.items()})
    r = np.random.RandomState(6)
    uncond_ids = np.full((1, SEQ), 639, np.int32)
    uncond_ids[0, 0] = 638
    t5_uncond = np.zeros((1, T5_SEQ), np.int32)
    t5_uncond[0, 0] = 1
    batch = {"latents": r.randn(2, 8, 8, 4).astype(np.float32)}
    if cached:
        batch.update(conds=r.randn(2, SEQ + T5_SEQ, 32).astype(np.float32),
                     pooled=r.randn(2, 24).astype(np.float32))
    else:
        batch.update(input_ids=_ids(4), uncond_ids=uncond_ids)
        if with_t5:
            batch.update(t5_ids=_t5_ids(5), t5_uncond_ids=t5_uncond)
    prefixes = tuple(jstep.component_prefix(c) + "." for c in trained)
    train = {k: v for k, v in params.items() if k.startswith(prefixes)}
    frozen = {k: v for k, v in params.items() if k not in train}
    cfg = {"trainer": {"precision": "32"}, "uncond": uncond}
    jspec = jstep.StepSpec.from_config(
        jconf.merge(jconf.default(), jconf.Config(cfg)), None, models.clip_config,
        models.vae_config, train_text_encoder="text_encoder" in trained,
        schedule=models.schedule, clip2_config=models.clip2_config,
        mmdit_config=models.mmdit_config, t5_config=models.t5_config if with_t5 else None)
    tm, tc1, tc2, tt = _tconfigs(models)
    tspec = tstep.StepSpec.from_config(
        tconf.merge(tconf.default(), tconf.Config(cfg)), None,
        tflow.FlowSchedule(**models.schedule.__dict__), vae_config=TVAEConfig(
            **models.vae_config.__dict__), clip_config=tc1, clip2_config=tc2,
        train_text_encoder="text_encoder" in trained, mmdit_config=tm,
        t5_config=tt if with_t5 else None)
    assert tspec.sd3 and jspec.sd3 and not tspec.sdxl

    rng = jax.random.PRNGKey(21)
    jnp_ = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    loss_fn = jax.value_and_grad(jstep.compute_loss, has_aux=True)
    (jloss, _), jgrads = loss_fn(jnp_(train), jnp_(frozen), jnp_(batch), rng, jspec)

    draws = jax_draws(rng, jspec, (2, 8, 8, 4))
    assert draws.timesteps.dtype == torch.float32
    if not cached:
        draws.uncond_u = torch.tensor(float(jax.random.uniform(jax.random.split(rng, 5)[1])))
    ttrain = {k: v.requires_grad_(True) for k, v in params_from_jax(train, device="cpu").items()}
    tbatch = {k: (nchw(v) if k == "latents" else torch.from_numpy(v)) for k, v in batch.items()}
    tloss, _ = tstep.compute_loss(ttrain, params_from_jax(frozen, device="cpu"), tbatch, None,
                                  tspec, draws)
    tloss.backward()

    assert abs(tloss.item() - float(jloss)) / abs(float(jloss)) < LOSS_TOL
    scale = max(np.abs(to_np(g)).max() for g in jgrads.values())
    for k in train:
        g = ttrain[k].grad
        want = to_np(jgrads[k])
        if g is None or not np.abs(want).max() > 1e-6 * scale:
            # zero in exact arithmetic: the key biases (softmax is shift
            # invariant), the towers under a dropped 'zeros' batch
            got = 0.0 if g is None else np.abs(to_np(g)).max()
            assert max(got, np.abs(want).max()) <= 1e-6 * scale, k
            continue
        assert _rel(g, want) < LOSS_TOL, k
    te = [k for k in train if k.startswith("condition_model.") and ttrain[k].grad is not None
          and ttrain[k].grad.abs().max() > 1e-6 * scale]
    assert bool(te) == (case in ("t5-eos-drop", "t5-zeros-kept", "no_t5-zeros-kept"))


# --- optim targets -------------------------------------------------------------------------

def _spec_tuple(s):
    return (s.rank, s.alpha, s.dropout)


def test_lora_sd3_resolves_like_jax():
    """lora_sd3 over SD3-Medium's keys: the same trainable keys, groups, LoRA
    specs and labels as JAX; the last (pre_only) block has no to_add_out and
    no ff_context; 24 blocks give 23 * 12 + 9 groups."""
    unet = list(tmmdit.mmdit_param_shapes(tmmdit.MMDiTConfig.sd3_medium()))
    clip1 = list(tclip.clip_param_shapes(tclip.CLIPTextConfig.vit_l()))
    want = jtargets.resolve_optim_target(jconf.load_optim_target("lora_sd3"), unet, clip1)
    got = ttargets.resolve_optim_target(tconf.load_optim_target("lora_sd3"), unet, clip1)
    assert got.keys() == want.keys()
    for comp in want:
        w, g = want[comp], got[comp]
        assert g.trainable == w.trainable, comp
        assert [(x.keys, dict(x.optimizer)) for x in g.groups] == \
            [(x.keys, dict(x.optimizer)) for x in w.groups], comp
        assert {p: _spec_tuple(s) for p, s in g.lora.items()} == \
            {p: _spec_tuple(s) for p, s in w.lora.items()}, comp
    assert ttargets.group_labels(got) == jtargets.group_labels(want)
    assert len(got["unet"].groups) == 23 * 12 + 9 and not got["text_encoder"].trainable
    assert "transformer_blocks.23.attn.to_add_out" not in got["unet"].lora
    assert "transformer_blocks.22.ff_context.net.2" in got["unet"].lora


def test_pos_embed_never_trainable(models):
    """full_unet over the MMDiT selects every parameter but the fixed sincos
    table, in both packages."""
    keys = list(models.unet)
    got = ttargets.resolve_optim_target(tconf.load_optim_target("full_unet"), keys, [])
    want = jtargets.resolve_optim_target(jconf.load_optim_target("full_unet"), keys, [])
    assert got["unet"].trainable == want["unet"].trainable
    assert tmmdit.POS_EMBED_KEY not in got["unet"].trainable
    assert set(got["unet"].trainable) == set(keys) - {tmmdit.POS_EMBED_KEY}


def test_lora_sd3_step_matches_jax(models):
    """One step of lora_sd3 (AdamW with fp32 masters and no moment dtype, the
    JAX package's default, so the kernel's xla rounding) on a cached batch:
    the port's make_train_step against JAX's, from JAX's factors and draws."""
    lr = 1e-3
    jres = jtargets.resolve_optim_target(jconf.load_optim_target("lora_sd3"), models.unet.keys(),
                                         models.clip.keys())
    tres = ttargets.resolve_optim_target(tconf.load_optim_target("lora_sd3"),
                                         list(models.unet), list(models.clip))
    labels = jtargets.group_labels(jres)
    assert ttargets.group_labels(tres) == labels
    unet = dict(models.unet)
    unet.update({k: np.asarray(v) for k, v in jlora.init_lora_params(
        jax.random.PRNGKey(0), unet, jres["unet"].lora).items()})
    for k in [k for k in unet if k.endswith(".lora_B")]:   # a nonzero delta from the start
        unet[k] = np.random.RandomState(len(k)).randn(*unet[k].shape).astype(np.float32) * 0.1
    params = {f"unet.{k}": v for k, v in unet.items()}
    trainable = {k: np.asarray(params[k], np.float32) for k in labels}
    frozen = {k: v for k, v in params.items() if k not in trainable}
    user = {"trainer": {"precision": "32"}, "batch_size": 2,
            "optimizer": {"params": {"lr": lr}, "lr_scale": {"enabled": False}}}
    overrides = {f"g{i}": dict(g.optimizer) for i, g in
                 enumerate(g for r in jres.values() for g in r.groups)}
    jcfg = jconf.merge(jconf.default(), jconf.Config(user))
    tcfg = tconf.merge(tconf.default(), tconf.Config(user))
    jtx, jlr = jopt.build_optimizer(jcfg, labels, overrides, 10, 1)
    ttx, tlr = topt.build_optimizer(tcfg, labels, overrides, 10, 1)
    assert all(t.xla for t in ttx.transforms.values())
    jspec = jstep.StepSpec.from_config(jcfg, None, models.clip_config, models.vae_config, False,
                                       schedule=models.schedule,
                                       clip2_config=models.clip2_config,
                                       mmdit_config=models.mmdit_config)
    tm, tc1, tc2, _ = _tconfigs(models)
    tspec = tstep.StepSpec.from_config(tcfg, None, tflow.FlowSchedule(**models.schedule.__dict__),
                                       clip_config=tc1, clip2_config=tc2, mmdit_config=tm)
    r = np.random.RandomState(8)
    batch = {"latents": r.randn(2, 8, 8, 4).astype(np.float32),
             "conds": r.randn(2, SEQ, 32).astype(np.float32),
             "pooled": r.randn(2, 24).astype(np.float32)}

    rng = jax.random.PRNGKey(1)
    jstate_ = jstep.init_train_state(rng, {k: jnp.asarray(v) for k, v in trainable.items()},
                                     jtx, ema_enabled=False, ema_decay=0.99)
    jfn = jstep.make_train_step(jspec, jtx, jlr, ema_enabled=False, donate=False)
    jstate_, jm = jfn(jstate_, {k: jnp.asarray(v) for k, v in frozen.items()},
                      {k: jnp.asarray(v) for k, v in batch.items()})

    tstate_ = tstep.init_train_state(params_from_jax(trainable, device="cpu"), ttx)
    tfn = tstep.make_train_step(tspec, ttx, tlr)
    tbatch = {k: nchw(v) if k == "latents" else torch.from_numpy(v) for k, v in batch.items()}
    tstate_, tm_ = tfn(tstate_, params_from_jax(frozen, device="cpu"), tbatch,
                       jax_draws(jax.random.fold_in(rng, 0), jspec, (2, 8, 8, 4)))
    jl, tl = float(jm["train_loss"]), float(tm_["train_loss"])
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    far = total = 0
    for k in trainable:
        g = to_np(tstate_.trainable[k]).astype(np.float64)
        w = np.asarray(jstate_.trainable[k], np.float64)
        d = np.abs(g - w)
        close = 1e-4 * np.abs(w).max()
        assert (d <= close + 2 * lr).all(), k
        far += int((d > close).sum())
        total += d.size
    assert far <= 1e-3 * total, f"{far} of {total} masters beyond the close bound"
    moved = [k for k in trainable if not np.array_equal(to_np(tstate_.trainable[k]),
                                                        trainable[k])]
    assert len(moved) == len(trainable)


# --- the cache CLI ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sd3_caches(sd3_dirs, tmp_path_factory):
    """Both cache CLIs on the tiny SD3 directory with T5 (the port's latent
    noise replayed from JAX's draws): (JAX file, port file)."""
    tmp = tmp_path_factory.mktemp("sd3_cache")
    data = make_image_dataset(tmp, n=3, size=(40, 52))
    user = {"model": str(sd3_dirs["t5"]), "seed": 5, "num_workers": 2,
            "data": {"resolution": 32, "concepts": [
                {"instance_set": {"path": str(data), "prompt": "{TXT_PROMPT}"}}]}}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcache, "latent_noise_source", _jax_latent_noise)
        for name, cli in (("jax", jcache), ("port", tcache)):
            cfg = dict(user, data=dict(user["data"], cache=str(tmp / f"{name}.safetensors")))
            path = tmp / f"{name}.yaml"
            path.write_text(json.dumps(cfg))
            args = ["--config", str(path), "--batch-size", "2", "--aug-group-size", "1"]
            result = CliRunner().invoke(cli.main, args + (["--device", "cpu"]
                                                          if name == "port" else []))
            assert result.exit_code == 0, result.output or repr(result.exception)
            out[name] = tmp / f"{name}.safetensors"
    return out["jax"], out["port"]


def test_sd3_cache_file_matches_jax_both_ways(sd3_caches):
    """{id}.cond holds both towers' states padded to 32 then T5's (77 + 77
    tokens), {id}.pooled the 24-wide pooled pair; values within CACHE_TOL;
    each package's LatentCache reads the other's file."""
    jfile, tfile = sd3_caches
    assert tstate.load_metadata(tfile) == jstate.load_metadata(jfile)
    want, got = jstate.load_state_dict(jfile), tstate.load_state_dict(tfile)
    assert got.keys() == want.keys()
    assert {k for k in got if k.endswith(".pooled")} == {f"{i}.pooled" for i in range(3)}
    assert got["0.cond"].shape == (2 * SEQ, 32) and got["0.pooled"].shape == (24,)
    for k in want:
        g, w = to_np(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.abs(g - w).max() <= CACHE_TOL * np.abs(w).max(), k
    for reader, path in ((tdatasets.LatentCache, jfile), (jdatasets.LatentCache, tfile)):
        c = reader(path)
        assert c.pooled(0).shape == (24,) and c.cond(0).shape == (2 * SEQ, 32)


# --- flow-Euler sampling ---------------------------------------------------------------------

def _sampler_specs(models, dtype, with_t5=True):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tm, tc1, tc2, tt = _tconfigs(models)
    js = jsampler.SamplerSpec(unet_config=None, vae_config=models.vae_config,
                              clip_config=models.clip_config, schedule=models.schedule,
                              dtype=jdt, clip2_config=models.clip2_config,
                              mmdit_config=models.mmdit_config,
                              t5_config=models.t5_config if with_t5 else None)
    ts = tsampler.SamplerSpec(unet_config=None, vae_config=TVAEConfig(**models.vae_config.__dict__),
                              clip_config=tc1, schedule=tflow.FlowSchedule(
                                  **models.schedule.__dict__), dtype=tdt, clip2_config=tc2,
                              mmdit_config=tm, t5_config=tt if with_t5 else None)
    return js, ts


def _flow_draws(rng, dtype):
    """The noise JAX's flow loop draws from ``rng`` (NCHW for the port)."""
    shape = (BATCH, H // 2, W // 2, 4)
    return tsampler.SamplerDraws(noise=nchw(jax.random.normal(jax.random.split(rng)[1], shape,
                                                              dtype)))


@pytest.mark.parametrize("img2img", [False, True])
def test_flow_euler_matches_jax(models, img2img):
    """The loop with the tiny MMDiT, guidance rescale 0.7, over 3 steps from
    JAX's noise: fp32 within SAMPLE_TOL, bf16 within BF16_SAMPLE_TOL; img2img
    starts at the ladder's second sigma."""
    r = np.random.RandomState(2)
    cond, uncond = (r.randn(BATCH, 9, 32).astype(np.float32) for _ in range(2))
    pooled, pooled_u = (r.randn(BATCH, 24).astype(np.float32) for _ in range(2))
    init = r.randn(BATCH, H // 2, W // 2, 4).astype(np.float32) if img2img else None
    for dtype in ("float32", "bfloat16"):
        js, ts = _sampler_specs(models, dtype)
        rng = jax.random.PRNGKey(3)
        kw = {"t_start_index": 1} if img2img else {}
        want = jsampler.flow_euler_sample_latents.__wrapped__(
            {k: jnp.asarray(v, js.dtype) for k, v in models.unet.items()}, jnp.asarray(cond),
            jnp.asarray(uncond), jnp.asarray(pooled), jnp.asarray(pooled_u), rng, js, STEPS,
            CFG, H, W, BATCH, init_latents=None if init is None else jnp.asarray(init),
            guidance_rescale=0.7, **kw)
        with torch.inference_mode():
            got = tsampler.flow_euler_sample_latents(
                {k: to_torch(v).to(ts.dtype) for k, v in models.unet.items()},
                torch.from_numpy(cond), torch.from_numpy(uncond), torch.from_numpy(pooled),
                torch.from_numpy(pooled_u), torch.Generator().manual_seed(0), ts, STEPS, CFG,
                H, W, BATCH, init_latents=None if init is None else nchw(init),
                guidance_rescale=0.7, draws=_flow_draws(rng, js.dtype), **kw)
        assert got.dtype == ts.dtype
        tol = SAMPLE_TOL if dtype == "float32" else BF16_SAMPLE_TOL
        assert _rel(got, nchw(want)) <= tol, (dtype, _rel(got, nchw(want)))


def _tokenize(prompts):
    return _ids(len(prompts[0]), len(prompts))


def _tokenize_3(prompts):
    return _t5_ids(len(prompts[0]), len(prompts))


def test_sd3_sample_images_matches_jax(models, monkeypatch):
    """Both towers and T5 -> flow-Euler -> the 16-channel-shifted VAE decode
    -> uint8, fp32, JAX's draws: every pixel within one uint8 level; 'ddim'
    selects flow_euler, another method raises."""
    monkeypatch.setattr(jsampler, "flow_euler_sample_latents",
                        jsampler.flow_euler_sample_latents.__wrapped__)
    js, ts = _sampler_specs(models, "float32")
    prompts, negative = ["a photo of a cat", "sks dog"], "blurry"
    want = jsampler.sample_images(models.unet, models.vae, models.clip, _tokenize, prompts,
                                  negative, js, steps=STEPS, cfg_scale=CFG, width=W, height=H,
                                  seed=11, method="flow_euler", clip2_params=models.clip2,
                                  t5_params=models.t5, tokenizer_3=_tokenize_3)
    tp = {n: params_from_jax(getattr(models, n), device="cpu")
          for n in ("unet", "vae", "clip", "clip2", "t5")}
    kw = dict(steps=STEPS, cfg_scale=CFG, width=W, height=H, device="cpu",
              clip2_params=tp["clip2"], t5_params=tp["t5"], tokenizer_3=_tokenize_3)
    for method in ("flow_euler", "ddim"):
        got = tsampler.sample_images(tp["unet"], tp["vae"], tp["clip"], _tokenize, prompts,
                                     negative, ts, method=method,
                                     draws=_flow_draws(jax.random.PRNGKey(11), jnp.float32), **kw)
        assert got.dtype == np.uint8 and got.shape == np.asarray(want).shape == (BATCH, H, W, 3)
        diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
        assert diff.max() <= 1, f"{method}: {(diff > 1).sum()} pixels off by more than 1"
    with pytest.raises(ValueError, match="flow_euler"):
        tsampler.sample_images(tp["unet"], tp["vae"], tp["clip"], _tokenize, prompts, negative,
                               ts, method="euler", **kw)
    with pytest.raises(ValueError, match="tokenizer_3"):
        tsampler.sample_images(tp["unet"], tp["vae"], tp["clip"], _tokenize, prompts, negative,
                               ts, **{**kw, "tokenizer_3": None})


# --- the whole slice through the CLIs -------------------------------------------------------

def test_sd3_train_and_sample_clis(sd3_dirs, tmp_path, monkeypatch):
    """cli.train with lora_sd3 on the tiny SD3 directory with T5, uncached
    (both tokenizers), CFG dropout 'eos': 2 steps end on a checkpoint of
    LoRA factors; cli.sample --ckpt with it writes a PNG at 32x32 (16x16
    latents) by flow_euler."""
    data = make_image_dataset(tmp_path, n=4, size=(40, 52))
    user = {"model": str(sd3_dirs["t5"]), "output_dir": str(tmp_path / "out"), "batch_size": 2,
            "seed": 3, "num_workers": 2, "optim_target": "lora_sd3",
            "uncond": {"enabled": True, "p": 0.5, "cond": "eos"},
            "data": {"resolution": 32, "concepts": [
                {"instance_set": {"path": str(data), "prompt": "{TXT_PROMPT}"}}]},
            "trainer": {"precision": "32", "max_epochs": 1},
            "optimizer": {"params": {"lr": 1e-3}, "lr_scale": {"enabled": False}},
            "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": 1}}
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps(user))
    result = CliRunner().invoke(ttrain_cli.main, ["--config", str(path), "--run-id", "r",
                                                  "--device", "cpu"])
    assert result.exit_code == 0, repr(result.exception)
    (ckpt,) = (tmp_path / "out" / "SCAL-SDT" / "r").glob("*.safetensors")
    tensors = tstate.load_state_dict(ckpt)
    factors = [k for k in tensors if k.endswith((".lora_A", ".lora_B"))]
    assert factors and all(k.startswith("unet.transformer_blocks.") for k in factors)
    assert not any(np.isnan(to_np(tensors[k])).any() for k in factors)

    out = tmp_path / "samples"
    result = CliRunner().invoke(tsample_cli.main, [
        "--model", str(sd3_dirs["t5"]), "--prompt", "a photo of the cat", "--ckpt", str(ckpt),
        "--steps", "2", "--width", "32", "--height", "32", "--method", "flow_euler",
        "--out", str(out), "--device", "cpu"])
    assert result.exit_code == 0, repr(result.exception)
    img = np.asarray(Image.open(out / "00_00.png"))
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
