"""Single-file checkpoints in the port against the JAX package: the loader
(``convert/loader.py`` ``load_components`` / ``load_ldm_checkpoint``) on an
SD1 LDM file (safetensors, and a Lightning-style ``.ckpt`` that pickles
other objects), an SD2 file with its OpenCLIP tower (2 and 24 resblocks),
an SDXL sgm file and an SD3 sgm file with and without T5; the ``.ckpt``
reader's refusal to run pickled code; an SD2-v loss through
``compute_loss``; and the train, cache and sample CLIs on a single file.

Both packages load the same file: configs are held field for field and
tensors bit for bit (dtype and bytes). The SD2-v loss and gradients are
held to 1e-3 relative with JAX's draws injected, as
tests/test_torch_step.py holds the cached step. The CLIs on a single file
are held bit for bit against the same CLIs on the equivalent diffusers
directory (the same weights and configs): cache file tensors, the final
checkpoint's tensors, and the PNG's pixels. The cases mirror
tests/test_sd2_support.py, tests/test_sd3_single_file.py and
tests/test_sdxl_support.py::test_sdxl_single_file_load."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.convert import loader as jloader
from scal_sdt_tpu.convert import mmdit_names as jmm
from scal_sdt_tpu.convert import sd_names as jnames
from scal_sdt_tpu.models.clip import CLIPTextConfig as JCLIPConfig, clip_param_shapes
from scal_sdt_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig, mmdit_param_shapes
from scal_sdt_tpu.models.t5 import T5Config as JT5Config, t5_param_shapes
from scal_sdt_tpu.models.unet import UNetConfig as JUNetConfig, unet_param_shapes
from scal_sdt_tpu.models.vae import VAEConfig as JVAEConfig, vae_param_shapes
from scal_sdt_tpu.training import step as jstep
from scal_sdt_tpu.utils import state as jstate

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.convert import loader as tloader
from scal_sdt_tpu_torch.training import step as tstep
from scal_sdt_tpu_torch.utils import state as tstate

from test_torch_sd_names import assert_same_state
from torch_port_helpers import jax_draws, nchw, rand_unet_params

# tiny architecture YAMLs: SD1's (num_heads) and SD2's (num_head_channels,
# linear projections; 64 channels, so GroupNorm(32) keeps two channels per
# group and the time embedding has gradients); num_groups is the JAX
# package's extension for tiny first stages
FIRST_STAGE = {"params": {"ddconfig": {"ch": 16, "ch_mult": [1, 2], "num_res_blocks": 1,
                                       "in_channels": 3, "out_ch": 3, "z_channels": 4,
                                       "num_groups": 8}}}
SD1_YAML = {"model": {"params": {
    "timesteps": 1000, "linear_start": 0.00085, "linear_end": 0.012,
    "unet_config": {"params": {"model_channels": 32, "channel_mult": [1, 2],
                               "num_res_blocks": 1, "in_channels": 4, "out_channels": 4,
                               "attention_resolutions": [1], "num_heads": 2,
                               "context_dim": 64}},
    "first_stage_config": FIRST_STAGE}}}
SD2_YAML = {"model": {"params": {
    "timesteps": 1000, "linear_start": 0.00085, "linear_end": 0.012, "parameterization": "v",
    "unet_config": {"params": {"model_channels": 64, "channel_mult": [1, 2],
                               "num_res_blocks": 1, "in_channels": 4, "out_channels": 4,
                               "attention_resolutions": [1, 2], "num_head_channels": 32,
                               "use_linear_in_transformer": True, "context_dim": 64}},
    "first_stage_config": FIRST_STAGE}}}
# the CLIP a single file's shapes give back: width // 64 heads
CLIP = dict(vocab_size=640, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=1, max_position_embeddings=77)


def write_yaml(path: Path, data: dict) -> str:
    path.write_text(json.dumps(data))
    return str(path)


def sd_models(yaml: dict, seed: int = 0, clip_act: str = "quick_gelu"):
    """JAX LoadedModels of numpy weights whose configs are those a single
    file with ``yaml`` gives back."""
    cfg = jconf.Config(yaml)
    unet, vae = JUNetConfig.from_ldm_config(cfg), JVAEConfig.from_ldm_config(cfg)
    clip = JCLIPConfig(**CLIP, hidden_act=clip_act)
    return jloader.LoadedModels(
        unet=rand_unet_params(unet_param_shapes(unet), seed), unet_config=unet,
        vae=rand_unet_params(vae_param_shapes(vae), seed + 1), vae_config=vae,
        clip=rand_unet_params(clip_param_shapes(clip), seed + 2), clip_config=clip,
        schedule=jloader.NoiseSchedule())


def to_openclip(clip: dict) -> dict:
    """A transformers-layout tower in OpenCLIP naming (the JAX package's
    converter), with the projection and logit scale a real file carries."""
    oc = jnames.convert_transformers_text_to_openclip(clip)
    d = clip["text_model.embeddings.token_embedding.weight"].shape[1]
    oc["text_projection"] = np.zeros((d, d), np.float32)
    oc["logit_scale"] = np.asarray(4.6, np.float32)
    return oc


def ldm_state(models, openclip: dict | None = None, dtype=np.float32) -> dict:
    """The single-file state of ``models`` by the JAX package's maps: the
    UNet under model.diffusion_model., the VAE under first_stage_model., the
    tower under cond_stage_model.transformer. (or ``openclip`` under
    cond_stage_model.model.)."""
    state = {f"model.diffusion_model.{k}": v for k, v in
             jnames.convert_unet_state_df_to_ldm(models.unet, models.unet_config).items()}
    state.update({f"first_stage_model.{k}": v for k, v in
                  jnames.convert_vae_state_df_to_ldm(models.vae, models.vae_config).items()})
    if openclip is None:
        state.update({f"cond_stage_model.transformer.{k}": v for k, v in models.clip.items()})
    else:
        state.update({f"cond_stage_model.model.{k}": v for k, v in openclip.items()})
    return {k: np.asarray(v).astype(dtype) for k, v in state.items()}


def assert_same_models(tm, jm):
    """Configs field for field, tensors bit for bit, the schedule's fields."""
    for what in ("unet", "vae", "clip", "clip2", "mmdit", "t5"):
        tc, jc = getattr(tm, f"{what}_config"), getattr(jm, f"{what}_config")
        assert (tc is None) == (jc is None), what
        if jc is not None:
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), what
    for what in ("unet", "vae", "clip", "clip2", "t5"):
        got, want = getattr(tm, what), getattr(jm, what)
        assert (got is None) == (want is None), what
        if want is not None:
            assert_same_state(got, want)
    assert type(tm.schedule).__name__ == type(jm.schedule).__name__
    fields = lambda s: {f.name: getattr(s, f.name) for f in dataclasses.fields(s) if f.init}
    assert fields(tm.schedule) == fields(jm.schedule)


def load_both(model: Path, **cfg):
    """load_components of both packages on one config."""
    user = {"model": str(model), **cfg}
    return (tloader.load_components(tconf.merge(tconf.default(), tconf.Config(user))),
            jloader.load_components(jconf.merge(jconf.default(), jconf.Config(user))))


class PickledCallback:
    """Stands for the Lightning objects an original SD .ckpt pickles (the
    JAX package imports it by name; the port never does)."""

    def __init__(self):
        self.best_model_score = 0.5


# --- SD1.x and SD2.x LDM files ------------------------------------------------------

@pytest.mark.parametrize("case", ["sd1-safetensors", "sd1-ckpt", "sd2-2layers", "sd2-24layers"])
def test_ldm_file_loads_as_jax(case, tmp_path):
    """An SD1 LDM file (fp16 safetensors, or a Lightning-style .ckpt whose
    pickle holds a callback object, global_step and the state_dict) with the
    bundled v1-shaped YAML; an SD2 file with its OpenCLIP tower of 2 or 24
    resblocks (24 load as 23 layers) with the SD2 YAML and ``schedule:
    {prediction_type: v}``, which the YAML's parameterization alone does
    not set."""
    sd2 = case.startswith("sd2")
    models = sd_models(SD2_YAML if sd2 else SD1_YAML, clip_act="gelu" if sd2 else "quick_gelu")
    openclip = None
    if sd2:
        n = int(case.split("-")[1].removesuffix("layers"))
        clip_cfg = dataclasses.replace(models.clip_config, num_hidden_layers=n)
        tower = rand_unet_params(clip_param_shapes(clip_cfg), 9)
        openclip = to_openclip(tower)
    state = ldm_state(models, openclip, np.float16 if case == "sd1-safetensors" else np.float32)
    if case == "sd1-ckpt":
        path = tmp_path / "model.ckpt"
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()},
                    "global_step": 470000, "callbacks": {"ModelCheckpoint": PickledCallback()}},
                   path)
        with pytest.raises(Exception):   # weights_only refuses the callback's class
            torch.load(path, weights_only=True)
    else:
        path = tmp_path / "model.safetensors"
        jstate.save_state_dict(state, path)
    yaml = write_yaml(tmp_path / "arch.yaml", SD2_YAML if sd2 else SD1_YAML)
    cfg = {"ldm_config": yaml, **({"schedule": {"prediction_type": "v"}} if sd2 else {})}
    tm, jm = load_both(path, **cfg)
    assert_same_models(tm, jm)
    if sd2:
        assert tm.clip_config.num_hidden_layers == (23 if n == 24 else n)
        assert tm.clip_config.hidden_act == "gelu" and tm.schedule.prediction_type == "v"
        assert tm.unet_config.num_attention_heads == (2, 4) and tm.unet_config.use_linear_projection
        # without the override the v file loads as epsilon, as in JAX
        tm2, jm2 = load_both(path, ldm_config=yaml)
        assert tm2.schedule.prediction_type == jm2.schedule.prediction_type == "epsilon"
    else:
        assert tm.clip_config == dataclasses.replace(tm.clip_config, **CLIP)
        if case == "sd1-safetensors":
            assert all(v.dtype == torch.float16 for v in tm.unet.values())


@pytest.mark.parametrize("layout", ["zip", "legacy", "legacy-payload-in-header"])
def test_ckpt_reader_runs_no_pickled_code(tmp_path, layout):
    """A .ckpt whose pickle would write a file when unpickled (its
    ``__reduce__`` names ``open``) and names a class of a module that does
    not exist: the port reads its tensors, writes no file and imports
    nothing. In the zip layout and in the legacy one alike, and where the
    payload stands in a legacy file's magic-number slot, which torch reads
    before the main object: there the read fails and still writes no file.
    (The JAX package's ``weights_only=False`` would run both, so it is not
    run here.)"""
    import builtins
    import pickle
    import sys

    from torch.serialization import MAGIC_NUMBER

    canary = tmp_path / "written_by_the_pickle.txt"

    class Opens:
        def __reduce__(self):
            return builtins.open, (str(canary), "w")

    class Missing:
        pass

    # the class's module exists only while the file is written
    parent, child = "a_module_that_does_not_exist", "a_module_that_does_not_exist.callbacks"
    Missing.__module__, Missing.__qualname__ = child, "Missing"
    stand_ins = {parent: type(sys)(parent), child: type(sys)(child)}
    stand_ins[child].Missing = Missing
    stand_ins[parent].callbacks = stand_ins[child]
    tensors = {"a": torch.arange(6, dtype=torch.float16).reshape(2, 3),
               "b": torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))}
    path = tmp_path / "evil.ckpt"
    sys.modules.update(stand_ins)
    try:
        torch.save({"state_dict": tensors, "opens": Opens(), "missing": Missing()}, path,
                   _use_new_zipfile_serialization=layout == "zip")
        if layout == "legacy-payload-in-header":
            # a legacy file begins with the pickled magic number: put the payload there
            body = path.read_bytes()
            with open(path, "wb") as f:
                pickle.dump(Opens(), f, protocol=2)
                f.write(body[len(pickle.dumps(MAGIC_NUMBER, protocol=2)):])
    finally:
        for name in stand_ins:
            del sys.modules[name]
    if layout == "legacy-payload-in-header":
        with pytest.raises(RuntimeError, match="magic number"):
            tstate.load_state_dict(path)
        assert not canary.exists()
        return
    got = tstate.load_state_dict(path)
    assert not canary.exists()
    assert "a_module_that_does_not_exist" not in " ".join(sys.modules)
    assert set(got) == {"a", "b"}
    assert got["a"].dtype == torch.float16 and torch.equal(got["a"], tensors["a"])
    assert got["b"].dtype == torch.bfloat16 and not got["b"].requires_grad
    assert torch.equal(got["b"], tensors["b"].detach())


def test_sd2_v_loss_through_compute_loss_matches_jax(tmp_path):
    """The SD2 file's UNet (per-level heads, linear projections), loaded by
    each package with ``schedule: {prediction_type: v}``, through the cached
    branch of compute_loss with JAX's draws: loss and gradients within 1e-3
    relative."""
    models = sd_models(SD2_YAML, seed=3, clip_act="gelu")
    openclip = to_openclip(models.clip)
    path = tmp_path / "sd2.safetensors"
    jstate.save_state_dict(ldm_state(models, openclip), path)
    tm, jm = load_both(path, ldm_config=write_yaml(tmp_path / "arch.yaml", SD2_YAML),
                       schedule={"prediction_type": "v"})
    cfg = {"trainer": {"precision": "32"}}
    jspec = jstep.StepSpec.from_config(jconf.merge(jconf.default(), jconf.Config(cfg)),
                                       jm.unet_config, jm.clip_config, jm.vae_config,
                                       train_text_encoder=False, schedule=jm.schedule)
    tspec = tstep.StepSpec.from_config(tconf.merge(tconf.default(), tconf.Config(cfg)),
                                       tm.unet_config, schedule=tm.schedule)
    assert tspec.schedule.prediction_type == "v"
    r = np.random.RandomState(4)
    batch = {"latents": r.randn(2, 8, 8, 4).astype(np.float32),
             "conds": r.randn(2, 7, 64).astype(np.float32)}
    train = {f"unet.{k}": np.asarray(v) for k, v in jm.unet.items()}
    rng = jax.random.PRNGKey(13)
    loss_fn = jax.value_and_grad(jstep.compute_loss, has_aux=True)
    (jloss, _), jgrads = jax.jit(lambda p, b, k: loss_fn(p, {}, b, k, jspec))(
        {k: jax.numpy.asarray(v) for k, v in train.items()},
        {k: jax.numpy.asarray(v) for k, v in batch.items()}, rng)
    ttrain = {f"unet.{k}": v.clone().requires_grad_(True) for k, v in tm.unet.items()}
    tloss, _ = tstep.compute_loss(
        ttrain, {}, {"latents": nchw(batch["latents"]), "conds": torch.from_numpy(batch["conds"])},
        None, tspec, jax_draws(rng, jspec, batch["latents"].shape))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) / abs(float(jloss)) < 1e-3
    for k in train:
        g, w = ttrain[k].grad.numpy(), np.asarray(jgrads[k])
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), k


# --- SDXL and SD3 sgm files ---------------------------------------------------------

def test_sdxl_single_file_load_matches_jax(tmp_path):
    """WebUI's SDXL file (the text_time UNet with label_emb, CLIP-L under
    conditioner.embedders.0.transformer, OpenCLIP bigG with its projection
    under conditioner.embedders.1.model) with an sgm YAML."""
    from torch_port_helpers import tiny_sdxl_models

    from test_torch_sd_names import SGM

    m = tiny_sdxl_models()
    state = {f"model.diffusion_model.{k}": v for k, v in
             jnames.convert_unet_state_df_to_ldm(m.unet, m.unet_config).items()}
    state.update({f"first_stage_model.{k}": v for k, v in
                  jnames.convert_vae_state_df_to_ldm(m.vae, m.vae_config).items()})
    state.update({f"conditioner.embedders.0.transformer.{k}": v for k, v in m.clip.items()})
    state.update({f"conditioner.embedders.1.model.{k}": v for k, v in
                  jnames.convert_transformers_text_to_openclip(m.clip2).items()})
    path = tmp_path / "sdxl.safetensors"
    jstate.save_state_dict(state, path)
    tm, jm = load_both(path, ldm_config=write_yaml(tmp_path / "sgm.yaml", SGM))
    assert_same_models(tm, jm)
    assert tm.is_sdxl and tm.vae_config.scaling_factor == 0.13025
    assert tm.unet_config.transformer_layers_per_block == (1, 2)
    assert tm.clip2_config.projection_dim == 32 and tm.clip_config.hidden_act == "quick_gelu"


def sd3_file(tmp_path: Path, with_t5: bool) -> Path:
    """An SD3 single file in the distribution layout, by the JAX package's
    maps: the MMDiT (head dim 64, so its shapes give the heads back, and
    SD3.5's qk norm) in sgm naming, the 16-channel VAE without quant convs,
    both projected towers and optionally T5."""
    mm = JMMDiTConfig(sample_size=8, patch_size=2, in_channels=4, out_channels=4, num_layers=2,
                      attention_head_dim=64, num_attention_heads=2, joint_attention_dim=32,
                      pooled_projection_dim=24, pos_embed_max_size=12, qk_norm="rms_norm")
    vae = JVAEConfig(latent_channels=16, block_out_channels=(16, 32), layers_per_block=1,
                     norm_num_groups=8, use_quant_conv=False, use_post_quant_conv=False)
    clip = dict(vocab_size=256, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                num_attention_heads=2, projection_dim=12)
    state = {f"model.diffusion_model.{k}": v for k, v in jmm.convert_mmdit_state_df_to_sgm(
        rand_unet_params(mmdit_param_shapes(mm), 1)).items()}
    state.update({f"first_stage_model.{k}": v for k, v in jnames.convert_vae_state_df_to_ldm(
        rand_unet_params(vae_param_shapes(vae), 2), vae).items()})
    for i, (tower, act) in enumerate((("clip_l", "quick_gelu"), ("clip_g", "gelu"))):
        shapes = clip_param_shapes(JCLIPConfig(**clip, hidden_act=act))
        state.update({f"text_encoders.{tower}.transformer.{k}": v
                      for k, v in rand_unet_params(shapes, 3 + i).items()})
    if with_t5:
        t5 = JT5Config(vocab_size=256, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=2,
                       feed_forward_proj="gated-gelu")
        state.update({f"text_encoders.t5xxl.transformer.{k}": v
                      for k, v in rand_unet_params(t5_param_shapes(t5), 5).items()})
    path = tmp_path / "sd3.safetensors"
    jstate.save_state_dict(state, path)
    return path


@pytest.mark.parametrize("with_t5", [False, True])
def test_sd3_single_file_loads_as_jax(with_t5, tmp_path):
    path = sd3_file(tmp_path, with_t5)
    tm, jm = load_both(path)
    assert_same_models(tm, jm)
    assert tm.is_sd3 and (tm.t5 is not None) == with_t5
    assert tm.mmdit_config.qk_norm == "rms_norm" and tm.vae_config.latent_channels == 16
    assert not tm.vae_config.use_quant_conv and tm.schedule.prediction_type == "flow"
    # without the fixed sincos buffer: synthesized at the grid size given
    state = {k: v for k, v in tstate.load_state_dict(path).items()
             if k != "model.diffusion_model.pos_embed"}
    bare = tmp_path / "no_pos.safetensors"
    tstate.save_state_dict(state, bare)
    tm2, jm2 = load_both(bare, mmdit_pos_embed_max_size=12)
    assert_same_models(tm2, jm2)
    from scal_sdt_tpu_torch.models.mmdit import sincos_pos_embed_2d

    assert torch.equal(tm2.unet["pos_embed.pos_embed"], sincos_pos_embed_2d(128, 12))
    # the head dim is not in the shapes: a wrong one gives other heads or raises
    with pytest.raises(ValueError, match="not divisible by head_dim"):
        load_both(path, mmdit_head_dim=48)
    if not with_t5:
        towerless = tmp_path / "towerless.safetensors"
        tstate.save_state_dict({k: v for k, v in state.items()
                                if not k.startswith("text_encoders.")}, towerless)
        for loader in (tloader, jloader):
            with pytest.raises(ValueError, match="incl-clips"):
                loader.load_ldm_checkpoint(towerless)


def test_vae_file_override_and_hub_ids(tmp_path):
    """``config.vae`` as a file (a first stage alone) replaces the bundled
    VAE, as in JAX; a path that does not exist raises JAX's error: it is no
    hub id (tests/test_torch_hub_tokenizer.py resolves cached hub ids)."""
    models = sd_models(SD1_YAML)
    path = tmp_path / "sd1.safetensors"
    jstate.save_state_dict(ldm_state(models), path)
    other = sd_models(SD1_YAML, seed=7)
    vae_file = tmp_path / "vae.safetensors"
    jstate.save_state_dict(jnames.convert_vae_state_df_to_ldm(other.vae, other.vae_config),
                           vae_file)
    yaml = write_yaml(tmp_path / "arch.yaml", SD1_YAML)
    tm, jm = load_both(path, ldm_config=yaml, vae=str(vae_file))
    assert_same_models(tm, jm)
    assert_same_state(tm.vae, other.vae)
    cfg = tconf.merge(tconf.default(), tconf.Config({"model": str(tmp_path / "org" / "name")}))
    with pytest.raises(FileNotFoundError, match="not found locally and is not a hub id"):
        tloader.load_components(cfg)


# --- the CLIs on a single file --------------------------------------------------------

@pytest.fixture(scope="module")
def file_and_dir(tmp_path_factory):
    """One SD1 model as a single file (with its YAML) and as the equivalent
    diffusers directory, a tokenizer and 4 images."""
    from helpers import make_image_dataset, write_diffusers_dir
    from test_torch_data import write_vocab

    tmp = tmp_path_factory.mktemp("single_file")
    models = sd_models(SD1_YAML, seed=11)
    path = tmp / "sd1.safetensors"
    jstate.save_state_dict(ldm_state(models), path)
    d = write_diffusers_dir(models, tmp / "dir")
    write_vocab(d / "tokenizer")
    images = make_image_dataset(tmp, n=4, size=(40, 52))
    return tmp, path, write_yaml(tmp / "arch.yaml", SD1_YAML), d, images


def _cli(main, args):
    result = CliRunner().invoke(main, args)
    assert result.exit_code == 0, result.output or repr(result.exception)


@pytest.mark.parametrize("cli", ["cache", "train"])
def test_cli_on_a_single_file_equals_the_directory(file_and_dir, cli):
    """The port's cache and train (2 steps, from images) CLIs with ``model:``
    the single file and ``ldm_config:`` its YAML give, bit for bit, what
    they give on the equivalent directory."""
    from scal_sdt_tpu_torch.cli import cache as tcache
    from scal_sdt_tpu_torch.cli import train as ttrain

    tmp, path, yaml, d, images = file_and_dir
    out = {}
    for name, model in (("file", path), ("dir", d)):
        root = tmp / cli / name
        root.mkdir(parents=True)
        user = {"model": str(model), "ldm_config": yaml, "tokenizer": str(d / "tokenizer"),
                "seed": 3, "num_workers": 1, "batch_size": 2, "output_dir": str(root),
                "data": {"resolution": 32, "concepts": [{"instance_set": {
                    "path": str(images), "prompt": "{TXT_PROMPT}"}}]},
                "trainer": {"precision": "32", "max_steps": 2},
                "optimizer": {"lr_scale": {"enabled": False}},
                "checkpoint": {"filename": "last", "every_n_epochs": None}}
        if cli == "cache":
            user["data"]["cache"] = str(root / "cache.safetensors")
        cfg = write_yaml(root / "cfg.yaml", user)
        if cli == "cache":
            _cli(tcache.main, ["--config", cfg, "--batch-size", "2", "--device", "cpu"])
            out[name] = tstate.load_state_dict(root / "cache.safetensors")
        else:
            _cli(ttrain.main, ["--config", cfg, "--run-id", "r", "--device", "cpu"])
            (ckpt,) = root.rglob("last.safetensors")
            out[name] = tstate.load_state_dict(ckpt)
    assert out["file"].keys() == out["dir"].keys() and out["dir"]
    for k, v in out["dir"].items():
        got = out["file"][k]
        assert got.dtype == v.dtype and torch.equal(got, v), k


def test_sample_cli_on_an_sd3_single_file_equals_the_directory(file_and_dir):
    """``cli.sample --model`` an SD3 single file without its sincos buffer,
    with ``--mmdit-head-dim 8`` (not 64: a tiny MMDiT) and
    ``--pos-embed-max-size 12``: the PNG of the equivalent directory, pixel
    for pixel. (The CLI takes no LDM YAML, as in JAX, so an SD1 / SD2 file
    there has the published widths, too large for this test.)"""
    from PIL import Image

    from scal_sdt_tpu.diffusion.flow import FlowSchedule as JFlow

    from helpers import write_diffusers_dir
    from scal_sdt_tpu_torch.cli import sample as tsample

    tmp, _, _, d, _ = file_and_dir
    mm = JMMDiTConfig(sample_size=128, patch_size=2, in_channels=16, out_channels=16,
                      num_layers=2, attention_head_dim=8, num_attention_heads=2,
                      joint_attention_dim=32, pooled_projection_dim=24, pos_embed_max_size=12)
    vae = JVAEConfig(latent_channels=16, block_out_channels=(16, 32), layers_per_block=1,
                     norm_num_groups=8, scaling_factor=1.5305, shift_factor=0.0609)
    clips = [JCLIPConfig(**{**CLIP, "hidden_size": 16, "intermediate_size": 32},
                         hidden_act=act, projection_dim=12) for act in ("quick_gelu", "gelu")]
    models = jloader.LoadedModels(
        unet=rand_unet_params(mmdit_param_shapes(mm), 21), unet_config=None,
        vae=rand_unet_params(vae_param_shapes(vae), 22), vae_config=vae,
        clip=rand_unet_params(clip_param_shapes(clips[0]), 23), clip_config=clips[0],
        schedule=JFlow(), clip2=rand_unet_params(clip_param_shapes(clips[1]), 24),
        clip2_config=clips[1], mmdit_config=mm)
    from scal_sdt_tpu.models.mmdit import sincos_pos_embed_2d

    models.unet["pos_embed.pos_embed"] = np.asarray(sincos_pos_embed_2d(16, 12))
    sd3_dir = write_diffusers_dir(models, tmp / "sd3_dir")
    state = {f"model.diffusion_model.{k}": v for k, v in
             jmm.convert_mmdit_state_df_to_sgm(models.unet).items() if k != "pos_embed"}
    state.update({f"first_stage_model.{k}": v
                  for k, v in jnames.convert_vae_state_df_to_ldm(models.vae, vae).items()})
    for tower, params in (("clip_l", models.clip), ("clip_g", models.clip2)):
        state.update({f"text_encoders.{tower}.transformer.{k}": v for k, v in params.items()})
    path = tmp / "sd3_sample.safetensors"
    jstate.save_state_dict(state, path)
    pngs = {}
    for name, args in (("file", ["--model", str(path), "--mmdit-head-dim", "8",
                                 "--pos-embed-max-size", "12"]),
                       ("dir", ["--model", str(sd3_dir)])):
        out = tmp / "sample" / name
        _cli(tsample.main, args + ["--prompt", "a cat", "--steps", "2", "--width", "32",
                                   "--height", "32", "--method", "flow_euler", "--tokenizer",
                                   str(d / "tokenizer"), "--out", str(out), "--device", "cpu"])
        pngs[name] = np.asarray(Image.open(out / "00_00.png"))
    assert pngs["file"].shape == (32, 32, 3)
    np.testing.assert_array_equal(pngs["file"], pngs["dir"])
