"""The port's SDXL slice against the JAX package, on the CPU.

The JAX package's tiny SDXL models (``torch_port_helpers.tiny_sdxl_models``:
a text_time UNet with transformer depths (1, 2), two 32-wide text towers,
tower 2 with a projection head) with seeded numpy weights go through both
packages; inputs come from numpy seeds, JAX's draws are injected. Tolerances:

* shape templates, configs, optim-target resolutions, loaded dicts, cache
  metadata and kohya keys: equal;
* the text_time UNet (fp32): within 1e-3 of the largest output (the bound of
  ``tests/test_torch_unet.py``), and remat changes nothing, bit for bit;
* ``clip_text_encode_sdxl`` (fp32): penultimate and pooled states within
  1e-5 of their largest entry (sums in another order);
* ``compute_loss`` in both SDXL branches (cached with ``pooled``; the
  dual-encoder branch with ``size_cond`` and CFG dropout 'eos' and 'zeros')
  and its gradients: within 1e-3 relative, the bound of
  ``tests/test_torch_step.py``; the key biases' gradients, zero in exact
  arithmetic, within 1e-6 of the largest gradient;
* the cache file: latents, conds and pooled within 1e-5 of their largest
  entry, and each package reads the other's;
* the four samplers with the tiny SDXL UNet over 3 steps: fp32 within 1e-4
  of JAX, bf16 within 2^-3 of JAX and at most 1.25 times JAX's own distance
  from the fp32 result (ROADMAP difference (n)); ``sample_images`` in fp32
  within one uint8 level;
* the whole slice: 2 steps of ``configs/sdxl_lora.yaml``'s ``lora_sdxl``
  target through the port's Trainer against JAX's train step on the same
  batches, factors and draws: losses within 1e-5 relative, the LoRA masters
  as ``tests/test_torch_trainer.py`` holds them (1e-4 of each tensor's
  largest entry in all but 1e-3 of the elements, 2 * lr * steps
  everywhere), and each package's checkpoint read by the other.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax
import jax.numpy as jnp

import scal_sdt_tpu.diffusion.sampler as jsampler
from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.cli import cache as jcache
from scal_sdt_tpu.convert import kohya as jkohya
from scal_sdt_tpu.convert import loader as jloader
from scal_sdt_tpu.convert import sd_names as jnames
from scal_sdt_tpu.data import datasets as jdatasets
from scal_sdt_tpu.models import clip as jclip
from scal_sdt_tpu.models import unet as junet
from scal_sdt_tpu.models.vae import VAEConfig as JVAEConfig
from scal_sdt_tpu.native import image as native_image
from scal_sdt_tpu.training import lora as jlora
from scal_sdt_tpu.training import optim_targets as jtargets
from scal_sdt_tpu.training import optimizers as jopt
from scal_sdt_tpu.training import step as jstep
from scal_sdt_tpu.training import checkpoint as jckpt

import scal_sdt_tpu_torch.diffusion.sampler as tsampler
from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.cli import cache as tcache
from scal_sdt_tpu_torch.cli import sample as tsample_cli
from scal_sdt_tpu_torch.convert import kohya as tkohya
from scal_sdt_tpu_torch.convert import loader as tloader
from scal_sdt_tpu_torch.convert.from_jax import params_from_jax
from scal_sdt_tpu_torch.data import datasets as tdatasets
from scal_sdt_tpu_torch.diffusion.schedule import NoiseSchedule as TSchedule
from scal_sdt_tpu_torch.models import clip as tclip
from scal_sdt_tpu_torch.models import unet as tunet
from scal_sdt_tpu_torch.models.vae import VAEConfig as TVAEConfig
from scal_sdt_tpu_torch.training import checkpoint as tckpt
from scal_sdt_tpu_torch.training import optim_targets as ttargets
from scal_sdt_tpu_torch.training import step as tstep
from scal_sdt_tpu_torch.training.trainer import Trainer as TTrainer
from scal_sdt_tpu_torch.utils import state as tstate

from helpers import make_image_dataset
from test_torch_cache import _jax_latent_noise
from test_torch_data import write_vocab
from test_torch_sampler import jax_draws as sampler_draws
from torch_port_helpers import (jax_draws, nchw, tiny_sdxl_dir,
                                tiny_sdxl_models, to_np, to_torch)

UNET_TOL = 1e-3      # the text_time UNet and compute_loss, relative
CLIP_TOL = 1e-5      # the SDXL encode, of the largest entry
CACHE_TOL = 1e-5     # the cache file's tensors, of the largest entry
SAMPLE_TOL = 1e-4    # fp32 sampler loops with the tiny UNet
BF16_SAMPLE_TOL = 2.0 ** -3
BF16_DRIFT = 1.25
SEQ = 77


def _rel(a, b) -> float:
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _ids(seed: int, batch: int = 2) -> np.ndarray:
    """Prompt ids below the towers' 640 rows: BOS 638, words, EOS 639 and
    EOS padding (what the CLIP-BPE tokenizer emits)."""
    r = np.random.RandomState(seed)
    ids = np.full((batch, SEQ), 639, np.int32)
    for b in range(batch):
        n = r.randint(3, 12)
        ids[b, 0] = 638
        ids[b, 1:n + 1] = r.randint(0, 600, n)
    return ids


@pytest.fixture(scope="module")
def models():
    return tiny_sdxl_models()


def _tconfigs(m):
    """The port's configs of the JAX ``LoadedModels`` ``m``."""
    return (tunet.UNetConfig(**m.unet_config.__dict__),
            tclip.CLIPTextConfig(**m.clip_config.__dict__),
            tclip.CLIPTextConfig(**m.clip2_config.__dict__))


# --- configs and shape templates ----------------------------------------------------

@pytest.mark.parametrize("name", ["sdxl", "tiny_sdxl"])
def test_unet_configs_and_shapes_match_jax(name):
    t, j = getattr(tunet.UNetConfig, name)(), getattr(junet.UNetConfig, name)()
    assert t.__dict__ == j.__dict__
    assert tunet.unet_param_shapes(t) == junet.unet_param_shapes(j)
    if name == "sdxl":
        # diffusers' count for SDXL-base (tests/test_sdxl_support.py)
        n = sum(int(np.prod(s)) for s in tunet.unet_param_shapes(t).values())
        assert n == 2_567_463_684
        assert [t.tf_depth_at(i) for i in range(3)] == [1, 2, 10]


def test_bigg_config_and_shapes_match_jax():
    t, j = tclip.CLIPTextConfig.sdxl_g(), jclip.CLIPTextConfig.sdxl_g()
    assert t.__dict__ == j.__dict__
    shapes = tclip.clip_param_shapes(t)
    assert shapes == jclip.clip_param_shapes(j)
    assert shapes["text_projection.weight"] == (1280, 1280)


def test_from_jax_carries_sdxl_params_bit_for_bit(models):
    """convert/from_jax.py carries SDXL's dicts in bf16 bit for bit,
    add_embedding.* and tower 2's text_projection.weight included."""
    for params in (models.unet, models.clip2):
        jp = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in params.items()}
        tp = params_from_jax(jp, device="cpu")
        assert tp.keys() == jp.keys()
        for k, v in jp.items():
            assert tp[k].dtype == torch.bfloat16 and tuple(tp[k].shape) == v.shape, k
            assert np.array_equal(tp[k].view(torch.int16).numpy(), v.view(np.int16)), k
    assert "add_embedding.linear_1.weight" in models.unet
    assert "text_projection.weight" in models.clip2


# --- the text_time UNet -------------------------------------------------------------

def _unet_inputs(seed: int = 1):
    r = np.random.RandomState(seed)
    return {"sample": r.randn(2, 8, 8, 4).astype(np.float32),
            "t": np.array([7, 421], np.int32),
            "ctx": r.randn(2, 11, 64).astype(np.float32),
            "text_embeds": r.randn(2, 32).astype(np.float32),
            "time_ids": np.array([[1024, 768, 16, 0, 1024, 1024],
                                  [512, 640, 0, 32, 576, 704]], np.float32)}


def _port_unet(params, x, config, remat=False):
    return tunet.unet_apply(params, nchw(x["sample"]), torch.from_numpy(x["t"].astype(np.int64)),
                            torch.from_numpy(x["ctx"]), config, remat=remat,
                            added_cond={"text_embeds": torch.from_numpy(x["text_embeds"]),
                                        "time_ids": torch.from_numpy(x["time_ids"])})


def test_text_time_unet_matches_jax(models):
    """fp32 forward within UNET_TOL; the time ids reach the output; remat
    gives the same output and gradients bit for bit; no added_cond raises."""
    x = _unet_inputs()
    jcfg = models.unet_config
    want = np.asarray(jax.jit(lambda p, s, t, c, te, ti: junet.unet_apply(
        p, s, t, c, jcfg, added_cond={"text_embeds": te, "time_ids": ti}))(
        {k: jnp.asarray(v) for k, v in models.unet.items()}, x["sample"], x["t"], x["ctx"],
        x["text_embeds"], x["time_ids"]))
    tcfg = _tconfigs(models)[0]
    params = params_from_jax(models.unet, device="cpu")
    got = _port_unet(params, x, tcfg).permute(0, 2, 3, 1)
    assert _rel(got, want) <= UNET_TOL

    moved = dict(x, time_ids=x["time_ids"] + 64.0)
    assert _rel(_port_unet(params, moved, tcfg).permute(0, 2, 3, 1), want) > 1e-3

    outs = []
    for remat in (False, True):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        out = _port_unet(p, x, tcfg, remat=remat)
        out.square().mean().backward()
        outs.append((out.detach(), {k: v.grad for k, v in p.items()}))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(outs[0][1][k], outs[1][1][k]) for k in params)
    with pytest.raises(ValueError, match="added_cond"):
        tunet.unet_apply(params, nchw(x["sample"]), torch.zeros(2, dtype=torch.int64),
                         torch.from_numpy(x["ctx"]), tcfg)


# --- the SDXL encode ----------------------------------------------------------------

def test_clip_encode_sdxl_matches_jax(models):
    """Both towers: the raw penultimate state, and for tower 2 the pooled
    projection at the first EOS; the dual-tower conditioning with tower 2's
    ids zeroed after the first EOS."""
    ids = _ids(3)
    # EOS at 639, as _ids writes it (the tiny towers keep CLIP's 49407)
    eos = {"eos_token_id": 639}
    tc1, tc2 = (dataclasses.replace(c, **eos) for c in _tconfigs(models)[1:])
    jc1, jc2 = (dataclasses.replace(c, **eos) for c in (models.clip_config, models.clip2_config))
    jp1 = {k: jnp.asarray(v) for k, v in models.clip.items()}
    jp2 = {k: jnp.asarray(v) for k, v in models.clip2.items()}
    tp1, tp2 = params_from_jax(models.clip, device="cpu"), params_from_jax(models.clip2,
                                                                           device="cpu")
    tids = torch.from_numpy(ids.astype(np.int64))
    for jp, tp, jc, tc in ((jp1, tp1, jc1, tc1), (jp2, tp2, jc2, tc2)):
        jpen, jpool = jclip.clip_text_encode_sdxl(jp, jnp.asarray(ids), jc)
        tpen, tpool = tclip.clip_text_encode_sdxl(tp, tids, tc)
        assert _rel(tpen, jpen) <= CLIP_TOL
        assert (tpool is None) == (jpool is None) == (jc.projection_dim is None)
        if jpool is not None:
            assert tpool.shape == (2, 32) and _rel(tpool, jpool) <= CLIP_TOL
    ids2 = tclip.second_tower_ids(tids, tc1.eos_token_id)
    first = int(np.argmax(ids[0] == 639))
    assert ids2[0, first] == 639 and not ids2[0, first + 1:].any()
    conds, pooled = tclip.encode_sdxl(tp1, tp2, tids, tc1, tc2)
    assert conds.shape == (2, SEQ, 64)
    _, want = jclip.clip_text_encode_sdxl(jp2, jnp.asarray(to_np(ids2).astype(np.int32)), jc2)
    assert _rel(pooled, want) <= CLIP_TOL


# --- compute_loss in both SDXL branches ---------------------------------------------

LOSS_CASES = {
    # (uncond section, trainable components, cached)
    "cached": ({}, ("unet",), True),
    "eos-drop": ({"enabled": True, "p": 1.0, "cond": "eos"},
                 ("unet", "text_encoder", "text_encoder_2"), False),
    "zeros-drop": ({"enabled": True, "p": 1.0, "cond": "zeros"}, ("unet", "text_encoder_2"),
                   False),
    "zeros-kept": ({"enabled": True, "p": 0.0, "cond": "zeros"},
                   ("text_encoder", "text_encoder_2"), False),
}


@pytest.fixture(scope="module")
def loss_inputs(models):
    params = {}
    for comp, p in (("unet", models.unet), ("text_encoder", models.clip),
                    ("text_encoder_2", models.clip2), ("vae", models.vae)):
        pre = "vae" if comp == "vae" else jstep.component_prefix(comp)
        params.update({f"{pre}.{k}": v for k, v in p.items()})
    r = np.random.RandomState(6)
    uncond = np.full((1, SEQ), 639, np.int32)
    uncond[0, 0] = 638
    batch = {"images": r.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
             "input_ids": _ids(4), "uncond_ids": uncond,
             "size_cond": np.array([[20, 24, 2, 0], [16, 16, 0, 0]], np.int32),
             "latents": r.randn(2, 8, 8, 4).astype(np.float32),
             "conds": r.randn(2, SEQ, 64).astype(np.float32),
             "pooled": r.randn(2, 32).astype(np.float32)}
    return params, batch


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_sdxl_compute_loss_and_grads_match_jax(models, loss_inputs, case):
    params, full = loss_inputs
    uncond, trained, cached = LOSS_CASES[case]
    keys = ("latents", "conds", "pooled") if cached else ("images", "input_ids", "uncond_ids",
                                                          "size_cond")
    batch = {k: full[k] for k in keys}
    prefixes = tuple(jstep.component_prefix(c) + "." for c in trained)
    train = {k: v for k, v in params.items() if k.startswith(prefixes)}
    frozen = {k: v for k, v in params.items() if k not in train}
    cfg = {"trainer": {"precision": "32"}, "uncond": uncond}
    jspec = jstep.StepSpec.from_config(
        jconf.merge(jconf.default(), jconf.Config(cfg)), models.unet_config, models.clip_config,
        models.vae_config, train_text_encoder=len(trained) > 1,
        clip2_config=models.clip2_config)
    tu, tc1, tc2 = _tconfigs(models)
    tspec = tstep.StepSpec.from_config(
        tconf.merge(tconf.default(), tconf.Config(cfg)), tu, vae_config=TVAEConfig.tiny(),
        clip_config=tc1, clip2_config=tc2, train_text_encoder=len(trained) > 1)
    assert tspec.sdxl and jspec.sdxl

    rng = jax.random.PRNGKey(21)
    jnp_ = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    loss_fn = jax.value_and_grad(jstep.compute_loss, has_aux=True)
    (jloss, _), jgrads = loss_fn(jnp_(train), jnp_(frozen), jnp_(batch), rng, jspec)

    latents_shape = (2, 8, 8, 4)
    draws = jax_draws(rng, jspec, latents_shape)
    if not cached:
        rng_latent, rng_uncond = jax.random.split(rng, 5)[:2]
        draws.latent_noise = nchw(jax.random.normal(rng_latent, latents_shape, jnp.float32))
        draws.uncond_u = torch.tensor(float(jax.random.uniform(rng_uncond)))
    ttrain = {k: v.requires_grad_(True) for k, v in params_from_jax(train, device="cpu").items()}
    tbatch = {k: (nchw(v) if k in ("images", "latents") else torch.from_numpy(v))
              for k, v in batch.items()}
    tloss, _ = tstep.compute_loss(ttrain, params_from_jax(frozen, device="cpu"), tbatch, None,
                                  tspec, draws)
    tloss.backward()

    assert abs(tloss.item() - float(jloss)) / abs(float(jloss)) < UNET_TOL
    scale = max(np.abs(to_np(g)).max() for g in jgrads.values())
    for k in train:
        g = ttrain[k].grad
        if g is None:   # tower 1's last layer and final norm: SDXL conditions on neither
            assert k.startswith("condition_model.encoder.") and (
                ".layers.1." in k or "final_layer_norm" in k), k
            assert not np.any(to_np(jgrads[k])), k
            continue
        if k.endswith("k_proj.bias") or k.endswith("to_k.bias"):
            assert max(np.abs(to_np(g)).max(), np.abs(to_np(jgrads[k])).max()) <= 1e-6 * scale
            continue
        assert _rel(g, jgrads[k]) < UNET_TOL, k
    te = [k for k in train if k.startswith("condition_model.") and ttrain[k].grad is not None
          and ttrain[k].grad.abs().max() > 0]
    assert bool(te) == (case in ("eos-drop", "zeros-kept"))


# --- optim target, loader -----------------------------------------------------------

def _spec_tuple(s):
    return (s.rank, s.alpha, s.dropout)


def test_lora_sdxl_resolves_like_jax():
    """lora_sdxl over SDXL-base's keys: the same trainable keys, groups, LoRA
    specs and labels as JAX; one group per LoRA module: 722 in the UNet, 72
    in tower 1, 192 in tower 2."""
    unet = list(tunet.unet_param_shapes(tunet.UNetConfig.sdxl()))
    clip1 = list(tclip.clip_param_shapes(tclip.CLIPTextConfig.vit_l()))
    clip2 = list(tclip.clip_param_shapes(tclip.CLIPTextConfig.sdxl_g()))
    want = jtargets.resolve_optim_target(jconf.load_optim_target("lora_sdxl"), unet, clip1,
                                         text_encoder_2_keys=clip2)
    got = ttargets.resolve_optim_target(tconf.load_optim_target("lora_sdxl"), unet, clip1,
                                        text_encoder_2_keys=clip2)
    assert got.keys() == want.keys() == {"unet", "text_encoder", "text_encoder_2"}
    for comp in want:
        w, g = want[comp], got[comp]
        assert g.trainable == w.trainable, comp
        assert [(x.keys, dict(x.optimizer)) for x in g.groups] == \
            [(x.keys, dict(x.optimizer)) for x in w.groups], comp
        assert {p: _spec_tuple(s) for p, s in g.lora.items()} == \
            {p: _spec_tuple(s) for p, s in w.lora.items()}, comp
    assert ttargets.group_labels(got) == jtargets.group_labels(want)
    assert [len(got[c].groups) for c in got] == [722, 72, 192]
    with pytest.raises(ValueError, match="text_encoder_2"):
        ttargets.resolve_optim_target(tconf.load_optim_target("lora_sdxl"), unet, clip1)


@pytest.fixture(scope="module")
def sdxl_dir(tmp_path_factory):
    d = tiny_sdxl_dir(tmp_path_factory.mktemp("sdxl") / "model")
    write_vocab(d / "tokenizer")
    return d


def test_loader_reads_an_sdxl_dir_like_jax(sdxl_dir, tmp_path):
    """The dicts and configs JAX's loader reads, tower 2 with its projection
    and without position_ids; JAX's two errors: a text_time UNet without a
    tower 2, a tower 2 without a projection head."""
    import shutil

    jm, tm = jloader.load_diffusers_dir(sdxl_dir), tloader.load_diffusers_dir(sdxl_dir)
    assert tm.is_sdxl and jm.is_sdxl
    for what in ("unet", "vae", "clip", "clip2"):
        assert getattr(tm, f"{what}_config").__dict__ == getattr(jm, f"{what}_config").__dict__
        got, want = getattr(tm, what), getattr(jm, what)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert tm.clip2_config.projection_dim == 32 and tm.clip_config.projection_dim is None

    d = tmp_path / "no_te2"
    shutil.copytree(sdxl_dir, d)
    shutil.rmtree(d / "text_encoder_2")
    for loader in (jloader, tloader):
        with pytest.raises(ValueError, match="text_encoder_2"):
            loader.load_diffusers_dir(d)
    shutil.copytree(sdxl_dir / "text_encoder_2", d / "text_encoder_2")
    cfg = json.loads((d / "text_encoder_2" / "config.json").read_text())
    del cfg["projection_dim"]
    (d / "text_encoder_2" / "config.json").write_text(json.dumps(cfg))
    for loader in (jloader, tloader):
        with pytest.raises(ValueError, match="projection head"):
            loader.load_diffusers_dir(d)


# --- the cache CLI ------------------------------------------------------------------

@pytest.fixture(scope="module", params=["native", "pil"])
def sdxl_caches(sdxl_dir, tmp_path_factory, request):
    """Both cache CLIs on the tiny SDXL directory (the port's latent noise
    replayed from JAX's draws), the images through the native decoder (both
    packages' default) or through PIL (the decoder off in both): (config
    dict, JAX file, port file)."""
    from scal_sdt_tpu_torch.native import image as tnative

    tmp = tmp_path_factory.mktemp("sdxl_cache")
    data = make_image_dataset(tmp, n=3, size=(40, 52))
    user = {"model": str(sdxl_dir), "seed": 5, "num_workers": 2,
            "data": {"resolution": 32, "concepts": [
                {"instance_set": {"path": str(data), "prompt": "{TXT_PROMPT}"}}]}}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "pil":
            mp.setattr(native_image, "available", lambda: False)
            mp.setattr(tnative, "available", lambda: False)
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
    return user, out["jax"], out["port"]


def test_sdxl_cache_file_matches_jax_both_ways(sdxl_caches):
    """The same keys ({id}.pooled beside {id}.cond) and metadata; values
    within CACHE_TOL; each package's LatentCache reads the other's file."""
    from scal_sdt_tpu.utils import state as jstate

    _, jfile, tfile = sdxl_caches
    assert tstate.load_metadata(tfile) == jstate.load_metadata(jfile)
    want, got = jstate.load_state_dict(jfile), tstate.load_state_dict(tfile)
    assert got.keys() == want.keys()
    assert {k for k in got if k.endswith(".pooled")} == {f"{i}.pooled" for i in range(3)}
    assert got["0.cond"].shape == (SEQ, 64) and got["0.pooled"].shape == (32,)
    for k in want:
        g, w = to_np(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.abs(g - w).max() <= CACHE_TOL * np.abs(w).max(), k
    for reader, path in ((tdatasets.LatentCache, jfile), (jdatasets.LatentCache, tfile)):
        c = reader(path)
        assert c.pooled(0).shape == (32,) and c.cond(0).shape == (SEQ, 64)


def test_trainer_refuses_an_sdxl_cache_without_pooled(sdxl_caches, tmp_path):
    user, _, tfile = sdxl_caches
    tensors = tstate.load_state_dict(tfile)
    path = tmp_path / "nopooled.safetensors"
    tstate.save_state_dict({k: v for k, v in tensors.items() if not k.endswith(".pooled")},
                           path, "safetensors", metadata=tstate.load_metadata(tfile))
    cfg = tconf.merge(tconf.default(), tconf.Config(
        dict(user, data=dict(user["data"], cache=str(path)))))
    with pytest.raises(ValueError, match="pooled"):
        TTrainer(cfg, tmp_path / "run", device="cpu")


# --- kohya import -------------------------------------------------------------------

def test_kohya_sdxl_import_matches_jax(models):
    """lora_te1_ / lora_te2_ keys and UNet keys in the LDM dialect (kohya's
    SDXL files) resolve to the same checkpoint tensors as JAX's import."""
    r = np.random.RandomState(8)
    layout = jnames.infer_unet_layout(models.unet.keys())
    pairs = jnames.unet_prefix_map(layout)
    state = {}
    unet_mods = ["add_embedding.linear_1", "down_blocks.1.attentions.0.proj_in",
                 "down_blocks.1.attentions.0.transformer_blocks.1.attn2.to_k",
                 "up_blocks.0.attentions.1.transformer_blocks.0.ff.net.2"]
    for path in unet_mods:
        ldm = jnames._apply_renames(path + ".", pairs)[:-1]
        state[f"lora_unet_{ldm.replace('.', '_')}"] = path
    for tag in ("te1", "te2"):
        state[f"lora_{tag}_text_model_encoder_layers_1_self_attn_q_proj"] = None
    kohya = {}
    for flat, path in state.items():
        kohya[f"{flat}.lora_down.weight"] = r.randn(4, 32).astype(np.float32)
        kohya[f"{flat}.lora_up.weight"] = r.randn(32, 4).astype(np.float32)
        kohya[f"{flat}.alpha"] = np.asarray(2.0, np.float32)
    # down_blocks.1.attentions.0 of the 2-level tiny UNet
    assert any(k.startswith("lora_unet_input_blocks_3_1_") for k in kohya)
    args = (models.unet.keys(), models.clip.keys())
    want = jkohya.from_kohya_format(kohya, *args, te2_names=models.clip2.keys())
    got = tkohya.from_kohya_format({k: torch.from_numpy(np.array(v)) for k, v in kohya.items()},
                                   *args, te2_names=models.clip2.keys())
    assert got.keys() == want.keys()
    assert any(k.startswith("condition_model.encoder_2.") for k in got)
    for k in want:
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="lora_te2_"):
        tkohya.from_kohya_format({k: torch.as_tensor(np.array(v)) for k, v in kohya.items()},
                                 *args)


# --- samplers -----------------------------------------------------------------------

H = W = 32     # the tiny VAE's 2 levels make 16x16 latents
BATCH, CFG = 2, 5.0
JAX_LOOPS = {"ddim": (jsampler.ddim_sample_latents, {}),
             "euler": (jsampler.euler_sample_latents, {"ancestral": False}),
             "euler_a": (jsampler.euler_sample_latents, {"ancestral": True}),
             "dpmpp_2m": (jsampler.dpmpp_2m_sample_latents, {})}
TORCH_LOOPS = {"ddim": (tsampler.ddim_sample_latents, {}),
               "euler": (tsampler.euler_sample_latents, {"ancestral": False}),
               "euler_a": (tsampler.euler_sample_latents, {"ancestral": True}),
               "dpmpp_2m": (tsampler.dpmpp_2m_sample_latents, {})}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _sampler_specs(models, dtype):
    jdt, tdt = DTYPES[dtype]
    tu, tc1, tc2 = _tconfigs(models)
    js = jsampler.SamplerSpec(unet_config=models.unet_config, vae_config=JVAEConfig.tiny(),
                              clip_config=models.clip_config, schedule=models.schedule,
                              dtype=jdt, clip2_config=models.clip2_config)
    ts = tsampler.SamplerSpec(unet_config=tu, vae_config=TVAEConfig.tiny(), clip_config=tc1,
                              schedule=TSchedule(), dtype=tdt, clip2_config=tc2)
    return js, ts


def _run_loops(models, method, dtype, steps=3):
    """One JAX loop (eager) and the port's, with JAX's draws and the CFG
    pair's added_cond (pooled pair, time ids [h, w, 0, 0, h, w])."""
    jdt, tdt = DTYPES[dtype]
    js, ts = _sampler_specs(models, dtype)
    r = np.random.RandomState(2)
    cond, uncond = (r.randn(BATCH, SEQ, 64).astype(np.float32) for _ in range(2))
    pooled = r.randn(2 * BATCH, 32).astype(np.float32)
    time_ids = np.tile(np.array([H, W, 0, 0, H, W], np.float32), (2 * BATCH, 1))
    rng = jax.random.PRNGKey(3)
    draws = sampler_draws(method, rng, js, steps, (BATCH, H // 2, W // 2, 4))
    jfn, jkw = JAX_LOOPS[method]
    want = jfn.__wrapped__(
        {k: jnp.asarray(v, jdt) for k, v in models.unet.items()}, jnp.asarray(cond, jdt),
        jnp.asarray(uncond, jdt), rng, js, steps, CFG, H, W, BATCH,
        added_cond={"text_embeds": jnp.asarray(pooled, jdt), "time_ids": jnp.asarray(time_ids)},
        **jkw)
    tfn, tkw = TORCH_LOOPS[method]
    with torch.inference_mode():
        got = tfn({k: to_torch(v).to(tdt) for k, v in models.unet.items()},
                  torch.from_numpy(cond).to(tdt), torch.from_numpy(uncond).to(tdt),
                  torch.Generator().manual_seed(0), ts, steps, CFG, H, W, BATCH, draws=draws,
                  added_cond={"text_embeds": torch.from_numpy(pooled).to(tdt),
                              "time_ids": torch.from_numpy(time_ids)}, **tkw)
    return got, np.asarray(want).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("method", list(JAX_LOOPS))
def test_sdxl_samplers_match_jax(models, method):
    got32, want32 = _run_loops(models, method, "float32")
    got16, want16 = _run_loops(models, method, "bfloat16")
    assert _rel(got32, want32) <= SAMPLE_TOL, f"{method} fp32: {_rel(got32, want32)}"
    assert _rel(got16, want16) <= BF16_SAMPLE_TOL, f"{method} bf16: {_rel(got16, want16)}"
    assert _rel(got16, want32) <= BF16_DRIFT * _rel(want16, want32), method


def _tokenize(prompts):
    return _ids(len(prompts[0]), len(prompts))


@pytest.mark.parametrize("method", ["ddim", "dpmpp_2m"])
def test_sdxl_sample_images_matches_jax(models, method, monkeypatch):
    """Both towers -> sampler with added_cond -> VAE decoder -> uint8 in fp32,
    JAX's draws: every pixel within one uint8 level. Without tower 2 the
    port raises."""
    for name in ("ddim_sample_latents", "dpmpp_2m_sample_latents"):
        monkeypatch.setattr(jsampler, name, getattr(jsampler, name).__wrapped__)
    js, ts = _sampler_specs(models, "float32")
    prompts, negative = ["a photo of a cat", "sks dog"], "blurry"
    want = jsampler.sample_images(models.unet, models.vae, models.clip, _tokenize, prompts,
                                  negative, js, steps=3, cfg_scale=CFG, width=W, height=H,
                                  seed=11, method=method, clip2_params=models.clip2)
    draws = sampler_draws(method, jax.random.PRNGKey(11), js, 3, (BATCH, H // 2, W // 2, 4))
    tp = {n: params_from_jax(getattr(models, n), device="cpu")
          for n in ("unet", "vae", "clip", "clip2")}
    got = tsampler.sample_images(tp["unet"], tp["vae"], tp["clip"], _tokenize, prompts,
                                 negative, ts, steps=3, cfg_scale=CFG, width=W, height=H,
                                 method=method, draws=draws, device="cpu",
                                 clip2_params=tp["clip2"])
    assert got.dtype == np.uint8 and got.shape == np.asarray(want).shape == (BATCH, H, W, 3)
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1, f"{method}: {(diff > 1).sum()} pixels off by more than 1"
    with pytest.raises(ValueError, match="clip2_params"):
        tsampler.sample_images(tp["unet"], tp["vae"], tp["clip"], _tokenize, prompts, negative,
                               ts, steps=1, device="cpu")


# --- the whole slice: lora_sdxl through the port's Trainer against JAX's step -------

SLICE_STEPS, SLICE_LR = 2, 1e-3


def _check_masters(got: dict, want: dict, lr: float, steps: int):
    """fp32 masters after ``steps`` Adam steps at ``lr``: within 1e-4 of the
    tensor's largest entry in all but 1e-3 of the elements, and within
    2 * lr * steps everywhere (an element whose gradient is near zero may
    take the other sign; Adam moves it by about lr either way)."""
    far, total = 0, 0
    for k in want:
        g, w = to_np(got[k]).astype(np.float64), to_np(want[k]).astype(np.float64)
        d = np.abs(g - w)
        close = 1e-4 * np.abs(w).max()
        assert (d <= close + 2 * lr * steps).all(), k
        far += int((d > close).sum())
        total += d.size
    assert far <= 1e-3 * total, f"{far} of {total} masters beyond the close bound"


def test_sdxl_lora_slice_matches_jax_train_step(sdxl_dir, tmp_path, monkeypatch):
    """The port's Trainer on the tiny SDXL directory with lora_sdxl (LoRA on
    the UNet and both towers), remat, uncached, size_cond from the pipeline
    and CFG dropout 'zeros' at p 0.5, for SLICE_STEPS steps from JAX's LoRA
    factors and draws; JAX's train step on the batches the port's pipeline
    made (through the native decoder, as both packages decode by default).
    Then each package restores the other's checkpoint."""
    data = make_image_dataset(tmp_path, n=4, size=(40, 52))
    user = {"model": str(sdxl_dir), "output_dir": str(tmp_path / "out"), "batch_size": 2,
            "seed": 3, "num_workers": 2, "optim_target": "lora_sdxl",
            "gradient_checkpointing": True,
            "uncond": {"enabled": True, "p": 0.5, "cond": "zeros"},
            "data": {"resolution": 32, "concepts": [
                {"instance_set": {"path": str(data), "prompt": "{TXT_PROMPT}"}}]},
            "trainer": {"precision": "32", "max_epochs": 1},
            "optimizer": {"params": {"lr": SLICE_LR}, "lr_scale": {"enabled": False}},
            "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None}}
    jcfg = jconf.merge(jconf.default(), jconf.Config(user))
    ttr = TTrainer(tconf.merge(tconf.default(), tconf.Config(user)), tmp_path / "port",
                   device="cpu")
    assert ttr.spec.sdxl and ttr.train_text_encoder

    jm = jloader.load_diffusers_dir(sdxl_dir)
    jres = jtargets.resolve_optim_target(jconf.load_optim_target("lora_sdxl"), jm.unet.keys(),
                                         jm.clip.keys(), text_encoder_2_keys=jm.clip2.keys())
    labels = jtargets.group_labels(jres)
    assert ttr.tx.labels == labels
    assert [len(r.lora) for r in jres.values()] == [len(r.lora) for r in ttr.resolutions.values()]
    comps = {"unet": dict(jm.unet), "text_encoder": dict(jm.clip),
             "text_encoder_2": dict(jm.clip2)}
    lora_rng = jax.random.PRNGKey(7)
    for comp, res in jres.items():
        comps[comp].update({k: np.asarray(v) for k, v in
                            jlora.init_lora_params(lora_rng, comps[comp], res.lora).items()})
    params = {f"{jstep.component_prefix(c)}.{k}": v for c, p in comps.items() for k, v in p.items()}
    params.update({f"vae.{k}": v for k, v in jm.vae.items()})
    trainable = {k: np.asarray(params[k], np.float32) for k in ttr.state.trainable}
    frozen = {k: v for k, v in params.items() if k not in trainable}
    assert frozen.keys() == ttr.frozen.keys()
    assert any(k.startswith("condition_model.encoder_2.") for k in trainable)
    with torch.no_grad():   # JAX's factors, copied into the port's masters in place
        for k, v in ttr.state.trainable.items():
            v.copy_(to_torch(trainable[k]))

    overrides = {f"g{i}": g.optimizer for i, g in
                 enumerate(g for r in jres.values() for g in r.groups)}
    jtx, jlr = jopt.build_optimizer(jcfg, labels, overrides, ttr.steps_per_epoch, 1)
    jspec = jstep.StepSpec.from_config(jcfg, jm.unet_config, jm.clip_config, jm.vae_config, True,
                                       schedule=jm.schedule, clip2_config=jm.clip2_config)
    rng = jax.random.PRNGKey(1)
    jstate = jstep.init_train_state(rng, {k: jnp.asarray(v) for k, v in trainable.items()}, jtx,
                                    ema_enabled=False, ema_decay=0.99)
    jfn = jstep.make_train_step(jspec, jtx, jlr, ema_enabled=False, donate=False, pack_spec=None)

    latents = (2, 16, 16, 4)

    def draws_fn(step):
        key = jax.random.fold_in(rng, step)
        d = jax_draws(key, jspec, latents)
        rng_latent, rng_uncond = jax.random.split(key, 5)[:2]
        d.latent_noise = nchw(jax.random.normal(rng_latent, latents, jnp.float32))
        d.uncond_u = torch.tensor(float(jax.random.uniform(rng_uncond)))
        return d

    batches, tlosses = [], []
    step_fn, log = ttr.train_step, ttr._log

    def record(state, frozen_, batch, draws=None):
        batches.append({k: v.clone() for k, v in batch.items()})
        return step_fn(state, frozen_, batch, draws)

    monkeypatch.setattr(ttr, "train_step", record)
    monkeypatch.setattr(ttr, "_log", lambda m, s: (tlosses.append(m["train_loss"]), log(m, s)))
    ttr.fit(max_steps_override=SLICE_STEPS, draws_fn=draws_fn)
    assert len(batches) == SLICE_STEPS and "size_cond" in batches[0]

    jfrozen = {k: jnp.asarray(v) for k, v in frozen.items()}
    jlosses = []
    for b in batches:
        jbatch = {k: jnp.asarray(to_np(v).transpose(0, 2, 3, 1) if k == "images" else to_np(v))
                  for k, v in b.items()}
        jstate, metrics = jfn(jstate, jfrozen, jbatch)
        jlosses.append(float(metrics["train_loss"]))
    for t, j in zip(tlosses, jlosses):
        assert abs(t - j) <= 1e-5 * abs(j), (tlosses, jlosses)
    jtrain = {k: np.asarray(v) for k, v in jstate.trainable.items()}
    _check_masters(ttr.state.trainable, jtrain, SLICE_LR, SLICE_STEPS)
    moved = [k for k in trainable if k.startswith("condition_model.encoder_2.")
             and not np.array_equal(jtrain[k], trainable[k])]
    assert moved

    # checkpoints across packages, both ways: the port's file carries tower
    # 2's factors under condition_model.encoder_2 and JAX reads it; the port
    # restores a file of JAX's masters
    (tfile,) = (tmp_path / "port").glob("*.safetensors")
    jtensors, _ = jckpt.load_checkpoint_tensors(tfile)
    assert {k for k in jtensors if not k.endswith(".lora_alpha")} == set(trainable)
    for k, v in ttr.state.trainable.items():
        np.testing.assert_array_equal(np.asarray(jtensors[k]), to_np(v), err_msg=k)
    jfile = tmp_path / "jax.safetensors"
    jckpt.save_checkpoint(jfile, jstate, frozen, save_train_state=False)
    restored = tckpt.restore_train_state(jfile, ttr.state)
    for k, v in restored.trainable.items():
        np.testing.assert_array_equal(to_np(v), jtrain[k], err_msg=k)

    # cli.sample --ckpt overlays either package's SDXL checkpoint: tower 2's
    # factors land in the second tower
    for path in (tfile, jfile):
        m = tloader.load_diffusers_dir(sdxl_dir)
        tsample_cli.merge_checkpoint(m, path)
        lora2 = [k for k in m.clip2 if k.endswith(".lora_B")]
        assert len(lora2) == 12 and any(m.clip2[k].abs().max() > 0 for k in lora2)
    out = tmp_path / "samples"
    result = CliRunner().invoke(tsample_cli.main, [
        "--model", str(sdxl_dir), "--prompt", "a cat", "--steps", "2", "--width", "32",
        "--height", "32", "--method", "dpmpp_2m", "--ckpt", str(jfile), "--out", str(out),
        "--device", "cpu"])
    assert result.exit_code == 0, result.output or repr(result.exception)
    assert len(list(out.glob("*.png"))) == 1
