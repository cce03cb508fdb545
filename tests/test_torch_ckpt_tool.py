"""The port's checkpoint toolchain against the JAX package's:
``cli/ckpt_tool.py`` (``prune`` in each branch, ``lora``, ``graft``,
``embedding``) and ``cli/extract_lora.py``.

Each command runs in both packages on the same input files, and the two
outputs are held to the same key set, dtypes, shapes and tensor bytes. The
one difference is JAX's: its ``save_state_dict`` writes a 0-dim tensor (a
LoRA alpha) with shape (1,) (``np.ascontiguousarray`` makes 0-dim arrays
1-dim), the port's with shape (); the bytes are the same. SVD factors are
held by their products: ``(alpha/rank) * up @ down`` within 1e-5 of the
largest entry of JAX's (singular vectors' signs are arbitrary). The inputs
are seeded numpy states at tiny sizes, checkpoints written by the port's
Trainer (a full fine-tune with an EMA, and LoRA with TI), and the cases of
tests/test_ckpt_tool.py, tests/test_extract_lora.py,
tests/test_graft_and_misc.py::test_graft_splices_subtree_from_donor and
tests/test_kohya_import.py::test_kohya_sdxl_ldm_naming_round_trip."""

import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from scal_sdt_tpu.cli import ckpt_tool as jtool
from scal_sdt_tpu.cli import extract_lora as jextract
from scal_sdt_tpu.convert import sd_names as jnames
from scal_sdt_tpu.models.clip import CLIPTextConfig as JCLIPConfig, clip_param_shapes
from scal_sdt_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig, mmdit_param_shapes
from scal_sdt_tpu.models.unet import UNetConfig as JUNetConfig, unet_param_shapes
from scal_sdt_tpu.models.vae import VAEConfig as JVAEConfig, vae_param_shapes
from scal_sdt_tpu.utils import state as jstate

from scal_sdt_tpu_torch.cli import ckpt_tool as ttool
from scal_sdt_tpu_torch.cli import extract_lora as textract
from scal_sdt_tpu_torch.convert.kohya import from_kohya_format, to_kohya_format
from scal_sdt_tpu_torch.convert.sd_names import apply_renames, unet_prefix_map
from scal_sdt_tpu_torch.models.unet import UNetConfig as TUNetConfig
from scal_sdt_tpu_torch.utils import state as tstate

from torch_port_helpers import rand_unet_params

UNET_KEYS = list(unet_param_shapes(JUNetConfig.sd15()))


def invoke(main, args):
    result = CliRunner().invoke(main, [str(a) for a in args])
    assert result.exit_code == 0, result.output or repr(result.exception)
    return result


def run_both(tmp_path, cmd: list):
    """``cmd`` (the output path as ``{out}``) through both packages' tool;
    returns (port output, JAX output)."""
    outs = []
    for name, main in (("port", ttool.main), ("jax", jtool.main)):
        out = tmp_path / name / "out.safetensors"
        out.parent.mkdir(parents=True, exist_ok=True)
        invoke(main, [out if a == "{out}" else a for a in cmd])
        outs.append(out)
    return outs


def assert_same_file(got_path, want_path):
    """Same keys, dtypes, shapes (0-dim or JAX's (1,)) and tensor bytes."""
    got, want = tstate.load_state_dict(got_path), jstate.load_state_dict(want_path)
    assert set(got) == set(want) and want
    for k, w in want.items():
        g = got[k]
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, k
        if g.dim() == 0:
            assert w.shape == (1,), k
        else:
            assert tuple(g.shape) == w.shape, k
        assert g.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() == w.tobytes(), k
    return got


def save(state: dict, path, metadata=None):
    jstate.save_state_dict(state, path, metadata=metadata)
    return path


# --- prune -------------------------------------------------------------------------

def _sd1_ckpt(tmp_path, ema=False, te=False):
    """tests/test_ckpt_tool.py's placeholder SD1.5 checkpoint: every UNet
    key (and optionally the EMA shadow and CLIP-L) as seeded (2,) vectors."""
    r = np.random.RandomState(1)
    tensors = {f"unet.{k}": r.randn(2).astype(np.float32) for k in UNET_KEYS}
    if ema:
        tensors.update({f"unet_ema.shadow_params.{k}": r.randn(2).astype(np.float32)
                        for k in UNET_KEYS})
    if te:   # the token table at ViT-L's width: prune tells SD2's by it
        tensors.update({f"condition_model.encoder.{k}": r.randn(
            *((3, 768) if "token_embedding" in k else (2,))).astype(np.float32)
            for k in clip_param_shapes(JCLIPConfig.vit_l())})
    tensors["unet.down_blocks.0.attentions.0.proj_in.lora_A"] = np.ones((2, 2), np.float32)
    return save(tensors, tmp_path / "train.safetensors",
                metadata={"json": json.dumps({"step": 10})})


def _vae_files(tmp_path):
    """The SD1.5 VAE's keys as (2,) vectors in a diffusers directory and as
    an LDM first-stage file."""
    r = np.random.RandomState(2)
    vae = {k: r.randn(*((2, 2) if k.endswith("to_q.weight") else (2,))).astype(np.float32)
           for k in vae_param_shapes(JVAEConfig.sd15())}
    d = tmp_path / "vae_dir"
    d.mkdir()
    save(vae, d / "diffusion_pytorch_model.safetensors")
    ldm = save({f"first_stage_model.{k}": v
                for k, v in jnames.convert_vae_state_df_to_ldm(vae).items()},
               tmp_path / "vae.safetensors")
    return d, ldm


PRUNE_CASES = ["sd1-fp16", "ema", "vae", "df-vae", "te", "pristine-te", "partial-sdxl", "sd2",
               "sd2-arch", "sdxl", "sd3-diffusers", "sd3-sgm"]


@pytest.mark.parametrize("case", PRUNE_CASES)
def test_prune_matches_jax(case, tmp_path):
    """prune in each branch: SD1.5 names by ``infer_unet_layout`` at fp16,
    ``--ema``, ``--vae`` (LDM file) and ``--df-vae`` (diffusers dir),
    ``--text-encoder`` from the checkpoint or ``--pristine-te``, a partial
    (KV-only) state by ``--arch sdxl``, SD2's OpenCLIP namespace (detected by
    width, and by ``--arch sd2``), SDXL's conditioner.embedders, SD3 in the
    diffusers layout and (with the sincos buffer synthesized) the sgm
    layout."""
    args = []
    if case in ("sd1-fp16", "ema", "vae", "df-vae", "te", "pristine-te"):
        ckpt = _sd1_ckpt(tmp_path, ema=case == "ema", te=case == "te")
        args = {"sd1-fp16": ["--unet-dtype", "fp16"], "ema": ["--ema", "--unet-dtype", "bf16"],
                "te": ["--text-encoder"]}.get(case, [])
        if case in ("vae", "df-vae"):
            vae_dir, vae_file = _vae_files(tmp_path)
            args = ["--vae", vae_file] if case == "vae" else ["--df-vae", vae_dir,
                                                             "--vae-dtype", "fp16"]
        if case == "pristine-te":
            pristine = tmp_path / "clip_l" / "text_encoder"
            pristine.mkdir(parents=True)
            save(rand_unet_params({k: (2,) for k in clip_param_shapes(JCLIPConfig.vit_l())}, 3),
                 pristine / "model.safetensors")
            args = ["--text-encoder", "--pristine-te", pristine.parent]
    elif case == "partial-sdxl":
        shapes = unet_param_shapes(JUNetConfig.sdxl())
        kv = {f"unet.{k}": v for k, v in rand_unet_params(
            {k: (2,) for k in shapes if k.endswith(("attn2.to_k.weight", "attn2.to_v.weight"))},
            4).items()}
        ckpt = save(kv, tmp_path / "kv.safetensors")
        args = ["--arch", "sdxl"]
    elif case in ("sd2", "sd2-arch"):
        te = JCLIPConfig(vocab_size=100, hidden_size=1024 if case == "sd2" else 64,
                         intermediate_size=128, num_hidden_layers=2, num_attention_heads=16,
                         hidden_act="gelu")
        state = {f"unet.{k}": v for k, v in
                 rand_unet_params(unet_param_shapes(JUNetConfig.tiny()), 5).items()}
        state.update({f"condition_model.encoder.{k}": v for k, v in
                      rand_unet_params(clip_param_shapes(te), 6).items()})
        ckpt = save(state, tmp_path / "sd2.safetensors")
        args = ["--text-encoder", "--text-encoder-dtype", "fp32"] + (
            ["--arch", "sd2"] if case == "sd2-arch" else [])
    elif case == "sdxl":
        from torch_port_helpers import tiny_sdxl_models

        m = tiny_sdxl_models()
        state = {f"unet.{k}": v for k, v in m.unet.items()}
        state.update({f"condition_model.encoder.{k}": v for k, v in m.clip.items()})
        state.update({f"condition_model.encoder_2.{k}": v for k, v in m.clip2.items()})
        ckpt = save(state, tmp_path / "sdxl.safetensors")
        args = ["--text-encoder"]
    else:
        mm = JMMDiTConfig.tiny()
        mmdit = rand_unet_params(mmdit_param_shapes(mm), 7)
        del mmdit["pos_embed.pos_embed"]   # training checkpoints leave the buffer out
        clip = JCLIPConfig(vocab_size=64, hidden_size=16, intermediate_size=32,
                           num_hidden_layers=2, num_attention_heads=2, projection_dim=12)
        state = {f"unet.{k}": v for k, v in mmdit.items()}
        for i, prefix in enumerate(("encoder", "encoder_2")):
            state.update({f"condition_model.{prefix}.{k}": v for k, v in
                          rand_unet_params(clip_param_shapes(clip), 8 + i).items()})
        ckpt = save(state, tmp_path / "sd3.safetensors")
        if case == "sd3-sgm":
            vae = rand_unet_params(vae_param_shapes(JVAEConfig.tiny()), 10)
            vae_file = save(jnames.convert_vae_state_df_to_ldm(vae, JVAEConfig.tiny()),
                            tmp_path / "vae.safetensors")
            args = ["--layout", "sgm", "--pos-embed-max-size", "12", "--text-encoder",
                    "--vae", vae_file, "--unet-dtype", "fp32"]
        else:
            args = ["--unet-dtype", "bf16"]
    t_out, j_out = run_both(tmp_path, ["prune", ckpt, "{out}", *args])
    got = assert_same_file(t_out, j_out)
    if case == "sd1-fp16":
        expected = {f"model.diffusion_model.{v}"
                    for v in jnames.unet_name_map(JUNetConfig.sd15(), UNET_KEYS).values()}
        assert set(got) == expected and all(v.dtype == torch.float16 for v in got.values())
    if case == "ema":   # the shadow's values, not the live weights'
        src = jstate.load_state_dict(ckpt)
        k = "model.diffusion_model.input_blocks.1.0.in_layers.2.weight"
        assert torch.equal(got[k], torch.from_numpy(
            src["unet_ema.shadow_params.down_blocks.0.resnets.0.conv1.weight"]).bfloat16())
    if case.startswith("sd2"):
        assert any(k.startswith("cond_stage_model.model.transformer.resblocks.") for k in got)
    if case == "sdxl":
        assert any(k.startswith("conditioner.embedders.1.model.") for k in got)
    if case == "sd3-sgm":
        assert "model.diffusion_model.pos_embed" in got


def test_prune_refuses_overwrite_and_a_missing_text_encoder(tmp_path, monkeypatch):
    """An existing output needs --overwrite; a checkpoint without text
    encoder weights and no --pristine-te raises the same actionable error in
    both packages when transformers' cache has no CLIP-L (here: transformers
    does not import)."""
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    ckpt = _sd1_ckpt(tmp_path)
    out = tmp_path / "out.safetensors"
    out.write_bytes(b"x")
    for main in (ttool.main, jtool.main):
        assert CliRunner().invoke(main, ["prune", str(ckpt), str(out)]).exit_code != 0
        invoke(main, ["prune", str(ckpt), str(out), "--overwrite"])
        result = CliRunner().invoke(main, ["prune", str(ckpt), str(tmp_path / "te.safetensors"),
                                           "--text-encoder", "--overwrite"])
        assert result.exit_code != 0 and "no pristine CLIP-L" in result.output, result.output


# --- lora, graft, embedding ----------------------------------------------------------

def _lora_tensors(sdxl: bool) -> dict:
    path = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q"
    t = {f"unet.{path}.lora_A": np.full((4, 640), 0.5, np.float32),
         f"unet.{path}.lora_B": np.ones((640, 4), np.float32),
         "unet.down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.lora_A":
             np.arange(8, dtype=np.float32).reshape(2, 4),
         "unet.down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.lora_B":
             np.ones((4, 2), np.float32),
         "unet.down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.lora_alpha":
             np.asarray(3, np.int32),
         "condition_model.encoder.text_model.encoder.layers.0.self_attn.q_proj.lora_A":
             np.zeros((4, 16), np.float32),
         "condition_model.encoder.text_model.encoder.layers.0.self_attn.q_proj.lora_B":
             np.ones((16, 4), np.float32),
         "unet.conv_in.weight": np.ones((2,), np.float32)}
    if sdxl:
        t["condition_model.encoder_2.text_model.encoder.layers.1.mlp.fc1.lora_A"] = \
            np.ones((4, 8), np.float32)
        t["condition_model.encoder_2.text_model.encoder.layers.1.mlp.fc1.lora_B"] = \
            np.ones((8, 4), np.float32)
    return t


@pytest.mark.parametrize("case", ["sd1", "sd1-ldm-naming-fp32", "sdxl"])
def test_lora_export_matches_jax(case, tmp_path):
    """kohya / AddNet export: diffusers-style UNet names for SD1 (or LDM
    names on request), LDM names and lora_te1_ / lora_te2_ for SDXL (auto);
    the alpha of modules without one from the run's config.yaml; fp16 by
    default."""
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.yaml").write_text(json.dumps({"optim_target": {"unet": {"targets": [
        {"lora": {"rank": 4, "alpha": 2}}]}}}))
    ckpt = save(_lora_tensors(case == "sdxl"), run / "lora.safetensors")
    args = {"sd1": [], "sd1-ldm-naming-fp32": ["--unet-naming", "ldm", "--dtype", "fp32"],
            "sdxl": []}[case]
    t_out, j_out = run_both(tmp_path, ["lora", ckpt, "{out}", *args])
    got = assert_same_file(t_out, j_out)
    if case == "sd1":
        assert "lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_up.weight" in got
        assert got["lora_te_text_model_encoder_layers_0_self_attn_q_proj.alpha"] == 2
        assert got["lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn2_to_k"
                   ".alpha"] == 3
        assert got["lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn2_to_k"
                   ".lora_down.weight"].dtype == torch.float16
    else:
        assert "lora_unet_input_blocks_4_1_transformer_blocks_0_attn1_to_q.lora_up.weight" in got
    if case == "sdxl":
        assert "lora_te2_text_model_encoder_layers_1_mlp_fc1.lora_down.weight" in got


def test_kohya_sdxl_ldm_naming_round_trip():
    """tests/test_kohya_import.py:127 in the port: export renames through the
    bijection (down_blocks.1.attentions.0 -> input_blocks.4.1), import
    resolves the LDM flats back against the diffusers-named model, as the
    JAX package's export names them."""
    from scal_sdt_tpu.cli.ckpt_tool import to_kohya_format as j_to_kohya

    cfg = TUNetConfig.sdxl()
    path = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q"
    factors = {f"{path}.lora_A": torch.zeros(4, 640), f"{path}.lora_B": torch.ones(640, 4),
               f"{path}.lora_alpha": torch.tensor(4, dtype=torch.int32)}
    pairs = unet_prefix_map(cfg)
    kohya = to_kohya_format({apply_renames(k, pairs): v for k, v in factors.items()},
                            "lora_unet")
    want = j_to_kohya({jnames._apply_renames(k, jnames.unet_prefix_map(JUNetConfig.sdxl())):
                       v.numpy() for k, v in factors.items()}, "lora_unet")
    assert kohya.keys() == want.keys()
    assert "lora_unet_input_blocks_4_1_transformer_blocks_0_attn1_to_q.lora_down.weight" in kohya
    back = from_kohya_format(kohya, list(unet_param_shapes(JUNetConfig.sdxl())), [])
    assert torch.equal(back[f"unet.{path}.lora_B"], factors[f"{path}.lora_B"])
    assert back[f"unet.{path}.lora_alpha"] == 4
    # a module without an alpha gets the fallback, as an int32 scalar
    out = to_kohya_format({"m.lora_A": torch.zeros(1, 1)}, "p", fallback_alpha=8)
    assert out["p_m.alpha"].dtype == torch.int32 and out["p_m.alpha"] == 8


def _write_ldm_model(path, unet_fill, clip_fill):
    """tests/test_graft_and_misc.py's SD1.5 LDM file of constant (2,) vectors."""
    unet = {k: np.full((2,), unet_fill, np.float32) for k in UNET_KEYS}
    state = {f"model.diffusion_model.{k}": v
             for k, v in jnames.convert_unet_state_df_to_ldm(unet).items()}
    state.update({f"cond_stage_model.transformer.{k}": np.full((2,), clip_fill, np.float32)
                  for k in clip_param_shapes(JCLIPConfig.vit_l())})
    return save(state, path)


def test_graft_splices_subtree_from_donor(tmp_path):
    base = _write_ldm_model(tmp_path / "base.safetensors", 0.0, 0.0)
    donor = _write_ldm_model(tmp_path / "donor.safetensors", 1.0, 1.0)
    spec = tmp_path / "spec.yaml"
    spec.write_text("unet:\n  targets:\n    - index: [ 'mid_block' ]\n      targets:\n"
                    "        - index: [ 'attentions' ]\n          targets:\n"
                    "            - source: 0\ntext_encoder:\n  targets:\n"
                    "    - index: [ 'text_model' ]\n      targets:\n"
                    "        - index: [ 'final_layer_norm' ]\n          source: 0\n")
    t_out, j_out = run_both(tmp_path, ["graft", base, donor, "{out}", "--layer-spec", spec,
                                       "--unet-dtype", "fp16"])
    got = assert_same_file(t_out, j_out)
    grafted = [k for k in got if k.startswith("model.diffusion_model.middle_block.1.")]
    assert grafted and all(float(got[k][0]) == 1.0 for k in grafted)
    assert float(got["cond_stage_model.transformer.text_model.final_layer_norm.weight"][0]) == 1.0
    rest = [k for k in got if k.startswith("model.diffusion_model.input_blocks.1.0.")]
    assert rest and all(float(got[k][0]) == 0.0 for k in rest)


# --- on checkpoints of the port's Trainer ------------------------------------------------

@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Two one-step runs of the port's train CLI on a tiny model directory
    whose CLIP table is the synthetic vocab: a full fine-tune with an fp32
    EMA, and LoRA (UNet and CLIP) with two TI vectors."""
    from scal_sdt_tpu_torch.cli import train as ttrain

    from helpers import make_image_dataset
    from test_torch_data import write_vocab
    from torch_port_helpers import tiny_model_dir

    tmp = tmp_path_factory.mktemp("port_runs")
    vocab = write_vocab(tmp / "vocab")
    n_vocab = len(json.loads((vocab / "vocab.json").read_text()))
    model = tiny_model_dir(tmp / "model", vocab_size=n_vocab)
    write_vocab(model / "tokenizer")
    data = make_image_dataset(tmp, n=2, size=(40, 52))
    lora = {"rank": 2, "alpha": 1}
    user = {"model": str(model), "output_dir": str(tmp / "out"), "batch_size": 2, "seed": 1,
            "num_workers": 1, "data": {"resolution": 32, "concepts": [
                {"instance_set": {"path": str(data), "prompt": "my-cat, {TXT_PROMPT}"}}]},
            "trainer": {"precision": "32", "max_steps": 1},
            "optimizer": {"params": {"lr": 1e-3}, "lr_scale": {"enabled": False}},
            "checkpoint": {"filename": "last", "every_n_epochs": None}}
    runs = {"full": {"ema": {"enabled": True}},
            "lora_ti": {"optim_target": {
                "unet": {"targets": [{"index": ["down_blocks.0"], "targets": [
                    {"index": ["attentions"], "targets": [{"targets": [
                        {"index": ["proj_in", "proj_out"], "lora": lora}]}]}]}]},
                "text_encoder": {"targets": [{"index": ["text_model.encoder.layers.0"],
                                              "targets": [{"index": ["self_attn.q_proj"],
                                                           "lora": lora}]}]}},
                "custom_embeddings": {"train": {"enabled": True, "tokens": [
                    {"keyword": "my-cat", "vectors_per_token": 2, "init": "the"}]}}}}
    out = {}
    for name, extra in runs.items():
        cfg = tmp / f"{name}.yaml"
        cfg.write_text(json.dumps({**user, **extra}))
        invoke(ttrain.main, ["--config", cfg, "--run-id", name, "--device", "cpu"])
        (out[name],) = (tmp / "out").rglob(f"{name}/last.safetensors")
    return tmp, model, out


@pytest.mark.parametrize("cmd", ["prune", "prune-ema", "lora", "embedding", "graft"])
def test_each_cli_on_a_port_trainer_checkpoint_matches_jax(port_runs, cmd, tmp_path):
    """prune (live and EMA weights, with the directory's VAE), lora,
    embedding and graft (the pruned model's UNet onto the directory) on the
    port Trainer's checkpoints."""
    tmp, model, ckpts = port_runs
    if cmd.startswith("prune"):
        args = ["prune", ckpts["full"], "{out}", "--df-vae", model / "vae",
                *(["--ema"] if cmd == "prune-ema" else [])]
    elif cmd == "lora":
        args = ["lora", ckpts["lora_ti"], "{out}"]
    elif cmd == "graft":
        pruned = tmp_path / "pruned.safetensors"
        invoke(ttool.main, ["prune", ckpts["full"], pruned, "--unet-dtype", "fp32"])
        spec = tmp_path / "spec.yaml"
        spec.write_text("unet:\n  targets:\n    - index: [ 'down_blocks.0' ]\n      source: 0\n")
        sd1 = tmp_path / "tiny_sd1.yaml"
        sd1.write_text(json.dumps({"model": {"params": {"unet_config": {"params": {
            "model_channels": 32, "channel_mult": [1, 2], "num_res_blocks": 1,
            "in_channels": 4, "out_channels": 4, "attention_resolutions": [1], "num_heads": 2,
            "context_dim": 32}}}}}))
        args = ["graft", model, pruned, "{out}", "--layer-spec", spec, "--ldm-config", sd1]
    else:
        t_dir, j_dir = tmp_path / "port_emb", tmp_path / "jax_emb"
        invoke(ttool.main, ["embedding", ckpts["lora_ti"], t_dir])
        invoke(jtool.main, ["embedding", ckpts["lora_ti"], j_dir])
        assert sorted(p.name for p in t_dir.iterdir()) == ["my-cat.safetensors"]
        got = assert_same_file(t_dir / "my-cat.safetensors", j_dir / "my-cat.safetensors")
        assert tuple(got["emb_params"].shape) == (2, 32)
        return
    t_out, j_out = run_both(tmp_path, args)
    got = assert_same_file(t_out, j_out)
    if cmd == "lora":
        assert sum(k.endswith(".alpha") for k in got) == 3
    if cmd == "prune-ema":
        live = tstate.load_state_dict(run_both(tmp_path / "live", ["prune", ckpts["full"],
                                                                     "{out}"])[0])
        assert any(not torch.equal(got[k], live[k]) for k in live)


# --- extract_lora (tests/test_extract_lora.py) ------------------------------------------

@pytest.mark.parametrize("case", ["exact-rank", "truncation", "addnet-scaling"])
def test_lora_approx_matches_jax(case):
    """Factors of a rank-4 delta, of a full 16x16 one cut to rank 2
    (Eckart-Young: the error is the tail singular values' norm), and AddNet's
    scaling identity; the port's product within 1e-5 of JAX's."""
    r = np.random.RandomState({"exact-rank": 0, "truncation": 1, "addnet-scaling": 2}[case])
    if case == "truncation":
        delta, rank = r.randn(16, 16).astype(np.float32), 2
    else:
        rank = 4
        delta = (r.randn(32, rank) @ r.randn(rank, 24)).astype(np.float32)
    down, up = textract.lora_approx(torch.from_numpy(delta), rank, "cpu")
    assert tuple(down.shape) == (rank, delta.shape[1]) and tuple(up.shape) == (delta.shape[0], rank)
    jdown, jup = jextract.lora_approx(delta, rank)
    want = jup @ jdown
    got = (up @ down).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if case == "truncation":
        s = np.linalg.svd(delta.astype(np.float64), compute_uv=False)
        np.testing.assert_allclose(np.linalg.norm(delta - got), np.linalg.norm(s[2:]), rtol=1e-5)
    else:
        scale = np.sqrt(rank / 1.0)
        np.testing.assert_allclose((1.0 / rank) * (up * scale) @ (down * scale), delta,
                                   rtol=1e-3, atol=1e-3)


def test_extract_lora_cli_matches_jax(port_runs, tmp_path):
    """extract_lora between the pruned port checkpoint (an LDM file, shaped
    by a tiny YAML; it holds no text tower) and its base directory, on UNet
    targets that include 1x1 convs (stored 2-D), and between two
    directories on UNet and TE
    targets (named relative to text_model.), in fp32: keys, dtypes and
    alphas as JAX's, products within 1e-5 of the largest entry of JAX's."""
    tmp, model, ckpts = port_runs
    pruned = tmp_path / "pruned.safetensors"
    invoke(ttool.main, ["prune", ckpts["full"], pruned, "--unet-dtype", "fp32"])
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(json.dumps({"model": {"params": {"unet_config": {"params": {
        "model_channels": 32, "channel_mult": [1, 2], "num_res_blocks": 1, "in_channels": 4,
        "out_channels": 4, "attention_resolutions": [1], "num_heads": 2, "context_dim": 32}}}}}))
    spec = tmp_path / "spec.yaml"
    attn1 = {"index": ["attn1"], "targets": [{"index": ["to_q", "to_k"],
                                              "lora": {"rank": 3, "alpha": 2}}]}
    spec.write_text(json.dumps({
        "unet": {"targets": [{"index": ["down_blocks.0", "up_blocks.1"], "targets": [
            {"index": ["attentions"], "targets": [{"targets": [
                {"index": ["proj_in", "proj_out"], "lora": {"rank": 2, "alpha": 1}},
                {"index": ["transformer_blocks"], "targets": [{"targets": [attn1]}]}]}]}]}]},
        "text_encoder": {"targets": [{"index": ["text_model.encoder.layers.0"], "targets": [
            {"index": ["mlp.fc1"], "lora": {"rank": 2, "alpha": 1}}]}]}}))
    other = tmp_path / "other"
    from torch_port_helpers import tiny_model_dir

    tiny_model_dir(other, vocab_size=640, seed=9)
    unet_only = tmp_path / "unet_only.yaml"
    unet_only.write_text(json.dumps({"unet": json.loads(spec.read_text())["unet"]}))
    for models, extra in (((pruned, model), ["--ldm-config", yaml, "--layer-spec", unet_only]),
                          ((other, model), ["--layer-spec", spec])):
        outs = []
        for name, main in (("port", textract.main), ("jax", jextract.main)):
            out = tmp_path / name / f"{models[0].name}.safetensors"
            out.parent.mkdir(exist_ok=True)
            invoke(main, [*models, out, "--dtype", "fp32", *extra]
                   + (["--device", "cpu"] if name == "port" else []))
            outs.append(out)
        got, want = tstate.load_state_dict(outs[0]), jstate.load_state_dict(outs[1])
        assert set(got) == set(want) and want
        for k, w in want.items():
            assert str(got[k].dtype).removeprefix("torch.") == w.dtype.name
            assert got[k].numel() == w.size and (got[k].dim() == 2) == (w.ndim == 2), k
        names = {k.rsplit(".", 2)[0] if k.endswith(".weight") else k.rsplit(".", 1)[0]
                 for k in want}
        for name in names:
            alpha = float(want[f"{name}.alpha"][0])
            assert int(got[f"{name}.alpha"]) == int(alpha)
            j_up, j_down = (want[f"{name}.lora_{w}.weight"].astype(np.float32)
                            for w in ("up", "down"))
            t_up, t_down = (got[f"{name}.lora_{w}.weight"].float().numpy() for w in ("up", "down"))
            rank = j_down.shape[0]
            jp, tp = (alpha / rank) * j_up @ j_down, (alpha / rank) * t_up @ t_down
            assert np.abs(tp - jp).max() <= 1e-5 * np.abs(jp).max(), name
        assert "lora_unet_down_blocks_0_attentions_0_proj_in.lora_down.weight" in got
        if models[0] == other:
            assert "lora_te_text_model_encoder_layers_0_mlp_fc1.lora_up.weight" in got
