"""The port's sample CLI (``cli/sample.py``) and kohya LoRA import
(``convert/kohya.py``) against the JAX package, on the CPU.

* ``is_kohya_lora`` / ``from_kohya_format``: the same tensors as JAX's from
  kohya files with diffusers-style and LDM-style UNet names, 1x1-conv
  factors reshaped, and the same refusals (an unresolvable key, a 3x3-conv
  factor).
* ``merge_checkpoint`` against JAX's ``_merge_checkpoint`` on one tiny
  diffusers directory: a port checkpoint, a JAX checkpoint (full fine-tune
  tensors and LoRA factors), a kohya file and a textual-inversion
  checkpoint leave the same components, bit for bit, and the trained TI
  keywords tokenize to the same ids.
* The CLI with ``--device cpu``: its PNGs are the pixels ``sample_images``
  returns for seed + rep; a LoRA overlay from a port checkpoint, a JAX
  checkpoint and a kohya file of the same factors gives the same PNGs, each
  unlike the bare model's; TI keywords from a checkpoint change the image;
  what is not ported is refused naming its ROADMAP item.
"""

import json
import logging
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

import jax
import jax.numpy as jnp

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.cli import sample as jsample_cli
from scal_sdt_tpu.cli.ckpt_tool import to_kohya_format
from scal_sdt_tpu.convert import kohya as jkohya
from scal_sdt_tpu.convert import loader as jloader
from scal_sdt_tpu.convert.sd_names import _apply_renames, infer_unet_layout, unet_prefix_map
from scal_sdt_tpu.text import bpe as jbpe
from scal_sdt_tpu.text import ti as jti
from scal_sdt_tpu.training import checkpoint as jckpt
from scal_sdt_tpu.training import step as jstep
from scal_sdt_tpu.utils import state as jstate

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.cli import sample as tsample_cli
from scal_sdt_tpu_torch.convert import kohya as tkohya
from scal_sdt_tpu_torch.convert import loader as tloader
from scal_sdt_tpu_torch.diffusion import sampler as tsampler
from scal_sdt_tpu_torch.text import bpe as tbpe
from scal_sdt_tpu_torch.text import ti as tti
from scal_sdt_tpu_torch.training import checkpoint as tckpt
from scal_sdt_tpu_torch.training import step as tstep
from scal_sdt_tpu_torch.utils import state as tstate

from test_torch_data import write_vocab
from torch_port_helpers import tiny_model_dir, tiny_sd3_dir, to_np, to_torch

# LoRA factors of the tiny UNet (a Linear and a 1x1 proj_in conv) and CLIP
LORA_MODULES = {
    "unet": ["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
             "down_blocks.0.attentions.0.proj_in",
             "up_blocks.1.attentions.1.transformer_blocks.0.ff.net.2"],
    "condition_model.encoder": ["text_model.encoder.layers.0.self_attn.q_proj"],
}
RANK = 4
SIZE = 32     # image side; the tiny VAE's 2 levels make 16x16 latents
TI_KEYWORD = "zz-style"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny SD1.x diffusers directory whose CLIP table is exactly the
    synthetic vocab (TI rows then land in trained_extra)."""
    tmp = tmp_path_factory.mktemp("sample_cli")
    vocab = write_vocab(tmp / "vocab")
    d = tiny_model_dir(tmp / "model", vocab_size=len(json.loads((vocab / "vocab.json")
                                                                .read_text())))
    write_vocab(d / "tokenizer")
    return d


def _config(conf, model_dir):
    return conf.merge(conf.default(), conf.Config({"model": str(model_dir)}))


def _lora_factors(models_unet, models_clip) -> dict:
    """Prefixed LoRA tensors (A, B, alpha) of LORA_MODULES, numpy, seeded."""
    rs = np.random.RandomState(0)
    out = {}
    for prefix, modules in LORA_MODULES.items():
        params = models_unet if prefix == "unet" else models_clip
        for m in modules:
            w = np.asarray(params[f"{m}.weight"])
            out[f"{prefix}.{m}.lora_A"] = (rs.randn(RANK, w.shape[1]) * 0.3).astype(np.float32)
            out[f"{prefix}.{m}.lora_B"] = (rs.randn(w.shape[0], RANK) * 0.3).astype(np.float32)
            out[f"{prefix}.{m}.lora_alpha"] = np.asarray(RANK, np.int32)
    return out


@pytest.fixture(scope="module")
def checkpoints(model_dir, tmp_path_factory):
    """name -> checkpoint path: 'port' and 'jax' hold a full fine-tune tensor
    and LoRA factors; 'lora-port', 'lora-jax' and 'kohya' the same LoRA
    factors only; 'ti' a trained keyword's rows and its ti_tokens."""
    tmp = tmp_path_factory.mktemp("ckpts")
    jm = jloader.load_components(_config(jconf, model_dir))
    lora = _lora_factors(jm.unet, jm.clip)
    full = dict(lora)
    full["unet.conv_in.weight"] = np.asarray(jm.unet["conv_in.weight"]) * 1.5
    full["vae.decoder.conv_out.bias"] = np.asarray(jm.vae["decoder.conv_out.bias"]) + 0.1

    def save_port(path, tensors, meta=None):
        """The port's checkpoint file (its resume sidecar, which sampling
        never reads, left out)."""
        trainable = {k: to_torch(v) for k, v in tensors.items() if not k.endswith("_alpha")}
        frozen = {k: to_torch(v) for k, v in tensors.items() if k.endswith("_alpha")}
        state = tstep.TrainState(step=3, trainable=trainable, opt_state=None,
                                 generator=torch.Generator())
        out, m = tckpt.checkpoint_state_dict(state, frozen)
        tstate.save_state_dict(out, path, metadata={"json": json.dumps({**m, **(meta or {})})})

    def save_jax(path, tensors):
        trainable = {k: jnp.asarray(v) for k, v in tensors.items() if not k.endswith("_alpha")}
        frozen = {k: jnp.asarray(v) for k, v in tensors.items() if k.endswith("_alpha")}
        state = jstep.TrainState(step=jnp.asarray(3, jnp.int32), trainable=trainable,
                                 opt_state=None, ema=None, rng=jax.random.PRNGKey(0))
        jckpt.save_checkpoint(path, state, frozen, save_train_state=False)

    paths = {name: tmp / f"{name}.safetensors"
             for name in ("port", "jax", "lora-port", "lora-jax", "kohya", "ti")}
    save_port(paths["port"], full)
    save_jax(paths["jax"], full)
    save_port(paths["lora-port"], lora)
    save_jax(paths["lora-jax"], lora)
    kohya = {}
    for prefix, kprefix in (("unet", "lora_unet"), ("condition_model.encoder", "lora_te")):
        part = {k[len(prefix) + 1:]: v for k, v in lora.items() if k.startswith(prefix + ".")}
        kohya.update(to_kohya_format(part, kprefix))
    # kohya stores 1x1-conv factors 4-d
    for k in [k for k in kohya if "proj_in" in k and k.endswith("weight")]:
        kohya[k] = kohya[k][:, :, None, None]
    jstate.save_state_dict(kohya, paths["kohya"])

    tokenizer = jbpe.CLIPBPETokenizer.from_dir(model_dir / "tokenizer")
    ti_clip, ti_meta = jti.setup_ti_training(
        dict(jm.clip), tokenizer, [jti.TITokenSpec(TI_KEYWORD, 2)], seed=1)
    extra = {"condition_model.encoder." + jti.TRAINED_EXTRA_KEY:
             np.asarray(ti_clip[jti.TRAINED_EXTRA_KEY]) * 50.0}
    save_port(paths["ti"], extra, {"ti_tokens": ti_meta})
    return paths


def _kohya_states(model_dir):
    """(diffusers-style kohya state, LDM-style one) of the LoRA factors."""
    jm = jloader.load_components(_config(jconf, model_dir))
    lora = _lora_factors(jm.unet, jm.clip)
    unet = {k[5:]: v for k, v in lora.items() if k.startswith("unet.")}
    te = {k[len("condition_model.encoder."):]: v for k, v in lora.items()
          if k.startswith("condition_model.encoder.")}
    df = {**to_kohya_format(dict(unet), "lora_unet"), **to_kohya_format(dict(te), "lora_te1")}
    pairs = unet_prefix_map(infer_unet_layout(jm.unet.keys()))
    ldm_unet = {_apply_renames(k.rsplit(".", 1)[0] + ".", pairs)[:-1] + "." + k.rsplit(".", 1)[1]:
                v for k, v in unet.items()}
    ldm = {**to_kohya_format(ldm_unet, "lora_unet"), **to_kohya_format(dict(te), "lora_te")}
    for state in (df, ldm):
        for k in [k for k in state if "proj_in" in k and k.endswith("down.weight")]:
            state[k] = state[k][:, :, None, None]
    assert any("input_blocks" in k for k in ldm)
    return jm, df, ldm


@pytest.mark.parametrize("naming", ["diffusers", "ldm"])
def test_from_kohya_format_matches_jax(model_dir, naming):
    jm, df, ldm = _kohya_states(model_dir)
    state = df if naming == "diffusers" else ldm
    assert tkohya.is_kohya_lora(state) and jkohya.is_kohya_lora(state)
    assert not tkohya.is_kohya_lora({"unet.x.lora_A": 0})
    want = jkohya.from_kohya_format(state, jm.unet.keys(), jm.clip.keys())
    got = tkohya.from_kohya_format({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
                                   jm.unet.keys(), jm.clip.keys())
    assert got.keys() == want.keys() and len(got) == 3 * 4
    for k, v in want.items():
        assert got[k].dtype == to_torch(v).dtype, k
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("bad", ["unresolved", "conv3x3"])
def test_from_kohya_format_refuses_like_jax(model_dir, bad):
    jm, df, _ = _kohya_states(model_dir)
    state = dict(df)
    if bad == "unresolved":
        state["lora_unet_no_such_module.lora_down.weight"] = np.zeros((4, 4), np.float32)
        match = "could not be resolved"
    else:
        k = next(k for k in state if "proj_in" in k and k.endswith("down.weight"))
        state[k] = np.zeros(state[k].shape[:2] + (3, 3), np.float32)
        match = "3x3-conv"
    with pytest.raises(ValueError, match=match):
        jkohya.from_kohya_format(state, jm.unet.keys(), jm.clip.keys())
    with pytest.raises(ValueError, match=match):
        tkohya.from_kohya_format({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
                                 jm.unet.keys(), jm.clip.keys())


@pytest.mark.parametrize("name", ["port", "jax", "kohya", "ti"])
def test_merge_checkpoint_matches_jax(model_dir, checkpoints, name):
    jm = jloader.load_components(_config(jconf, model_dir))
    tm = tloader.load_components(_config(tconf, model_dir))
    jmeta = jsample_cli._merge_checkpoint(jm, checkpoints[name])
    tmeta = tsample_cli.merge_checkpoint(tm, checkpoints[name])
    assert tmeta == jmeta
    for comp in ("unet", "vae", "clip"):
        want, got = getattr(jm, comp), getattr(tm, comp)
        assert got.keys() == want.keys(), comp
        for k, v in want.items():
            assert np.array_equal(to_np(got[k]), np.asarray(v).astype(to_np(got[k]).dtype)), k
    if name == "ti":
        jtok = jbpe.CLIPBPETokenizer.from_dir(model_dir / "tokenizer")
        ttok = tbpe.CLIPBPETokenizer.from_dir(model_dir / "tokenizer")
        jti.register_ti_tokens_for_inference(jtok, jmeta["ti_tokens"])
        tti.register_ti_tokens_for_inference(ttok, tmeta["ti_tokens"])
        prompt = [f"a photo, {TI_KEYWORD}"]
        assert np.array_equal(ttok(prompt), jtok(prompt))
        assert ttok(prompt).max() >= len(jm.clip["text_model.embeddings.token_embedding.weight"])


def _run(model_dir, out, *extra, prompts=("a photo of a cat",)):
    args = ["--model", str(model_dir), "--steps", "2", "--width", str(SIZE), "--height",
            str(SIZE), "--cfg", "5", "--out", str(out), "--device", "cpu"]
    for p in prompts:
        args += ["--prompt", p]
    result = CliRunner().invoke(tsample_cli.main, args + list(extra))
    assert result.exit_code == 0, repr(result.exception)
    return {p.name: np.asarray(Image.open(p)) for p in sorted(out.glob("*.png"))}


def test_sample_cli_writes_the_pixels_of_sample_images(model_dir, tmp_path):
    """Two prompts, two reps: 00_00 .. 01_01, each rep the pixels of
    sample_images at seed + rep."""
    prompts = ("a photo of a cat", "the dog")
    got = _run(model_dir, tmp_path / "out", "--num", "2", "--seed", "7",
               "--method", "euler_a", "--negative", "blurry", prompts=prompts)
    assert sorted(got) == ["00_00.png", "00_01.png", "01_00.png", "01_01.png"]
    tm = tloader.load_components(_config(tconf, model_dir))
    spec = tsampler.SamplerSpec(unet_config=tm.unet_config, vae_config=tm.vae_config,
                                clip_config=tm.clip_config, schedule=tm.schedule)
    tok = tbpe.CLIPBPETokenizer.from_dir(model_dir / "tokenizer")
    for rep in range(2):
        want = tsampler.sample_images(tm.unet, tm.vae, tm.clip, tok, list(prompts), "blurry",
                                      spec, steps=2, cfg_scale=5.0, width=SIZE, height=SIZE,
                                      seed=7 + rep, method="euler_a", device="cpu")
        for i in range(2):
            assert got[f"{i:02d}_{rep:02d}.png"].shape == (SIZE, SIZE, 3)
            assert np.array_equal(got[f"{i:02d}_{rep:02d}.png"], want[i]), (i, rep)


def test_sample_cli_overlays_lora_from_either_package_and_kohya(model_dir, checkpoints, tmp_path):
    bare = _run(model_dir, tmp_path / "bare")
    outs = {name: _run(model_dir, tmp_path / name, "--ckpt", str(checkpoints[name]))
            for name in ("lora-port", "lora-jax", "kohya")}
    for name, out in outs.items():
        assert np.array_equal(out["00_00.png"], outs["lora-port"]["00_00.png"]), name
    assert not np.array_equal(bare["00_00.png"], outs["lora-port"]["00_00.png"])


def test_sample_cli_img2img_and_ti_keywords(model_dir, checkpoints, tmp_path, caplog):
    prompt = (f"a photo, {TI_KEYWORD}",)
    init = tmp_path / "init.png"
    Image.fromarray(np.random.RandomState(3).randint(0, 255, (40, 48, 3), np.uint8)).save(init)
    bare = _run(model_dir, tmp_path / "bare", "--init-image", str(init), prompts=prompt)
    with caplog.at_level(logging.INFO, logger="sample"):
        ti = _run(model_dir, tmp_path / "ti", "--init-image", str(init), "--ckpt",
                  str(checkpoints["ti"]), prompts=prompt)
    assert f"Registered trained TI keywords: {TI_KEYWORD}" in caplog.text
    assert bare["00_00.png"].shape == (SIZE, SIZE, 3)
    assert not np.array_equal(bare["00_00.png"], ti["00_00.png"])


@pytest.mark.parametrize("case", ["tokenizer-3", "mmdit-head-dim", "pos-embed-max-size",
                                  "single-file", "cuda"])
def test_sample_cli_refuses_what_is_not_ported(model_dir, tmp_path, monkeypatch, case):
    """What the single-file path refuses, as the JAX package does: an SD3
    file whose MMDiT width the given ``--mmdit-head-dim`` does not divide, a
    ``--pos-embed-max-size`` that contradicts the file's sincos table, and
    an LDM file whose UNet is not the bundled v1 architecture (the CLI takes
    no LDM YAML; tests/test_torch_single_file.py samples single files). An
    SD3 model with T5 whose tokenizer_3 needs the `tokenizers` package
    raises naming it when the package does not import (SD3 itself is
    ported: tests/test_torch_sd3.py)."""
    args = ["--model", str(model_dir), "--prompt", "a cat", "--out", str(tmp_path)]
    want = {"tokenizer-3": (ImportError, "`tokenizers` package"),
            "mmdit-head-dim": (ValueError, "not divisible by head_dim 64"),
            "pos-embed-max-size": (ValueError, "conflicts with the checkpoint's own sincos"),
            "single-file": (ValueError, "not consumed by the UNetConfig layout"),
            "cuda": (RuntimeError, "CUDA")}[case]
    # a stub SD3 file (width 16, a 12x12 sincos table): config inference
    # reads these before anything else
    sd3_file = tmp_path / "sd3.safetensors"
    tstate.save_state_dict({f"model.diffusion_model.{k}": torch.zeros(shape) for k, shape in {
        "x_embedder.proj.weight": (16, 4, 2, 2), "pos_embed": (1, 144, 16),
        "joint_blocks.0.x_block.attn.qkv.weight": (48, 16)}.items()}, sd3_file)
    if case == "tokenizer-3":
        sd3, _ = tiny_sd3_dir(tmp_path / "sd3")
        monkeypatch.setitem(sys.modules, "tokenizers", None)   # import raises
        args = ["--model", str(sd3), "--prompt", "a cat", "--out", str(tmp_path),
                "--tokenizer", "hash", "--tokenizer-3", str(sd3 / "tokenizer_3"),
                "--device", "cpu"]
    elif case == "mmdit-head-dim":
        args = ["--model", str(sd3_file), "--prompt", "a cat", "--out", str(tmp_path),
                "--mmdit-head-dim", "64", "--device", "cpu"]
    elif case == "pos-embed-max-size":
        args = ["--model", str(sd3_file), "--prompt", "a cat", "--out", str(tmp_path),
                "--mmdit-head-dim", "8", "--pos-embed-max-size", "192", "--device", "cpu"]
    elif case == "single-file":
        from scal_sdt_tpu_torch.convert.loader import load_diffusers_dir
        from scal_sdt_tpu_torch.convert.sd_names import convert_unet_state_df_to_ldm

        tiny = load_diffusers_dir(model_dir)
        f = tmp_path / "tiny_sd1.safetensors"
        tstate.save_state_dict({f"model.diffusion_model.{k}": v for k, v in
                                convert_unet_state_df_to_ldm(tiny.unet, tiny.unet_config).items()},
                               f)
        args = ["--model", str(f), "--prompt", "a cat", "--out", str(tmp_path), "--device", "cpu"]
    elif torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is not refused")
    result = CliRunner().invoke(tsample_cli.main, args)
    assert isinstance(result.exception, want[0]) and want[1] in str(result.exception), \
        repr(result.exception)
