"""Custom embeddings and textual inversion in the port (``text/embeddings.py``,
``text/ti.py``, ``models/clip.py`` ``trained_extra``) against the JAX
package, and the whole slice (LoRA, EMA and textual inversion together)
through both Trainers and the port's train CLI, on the CPU.

* ``setup_ti_training`` (init from a word, and random rows from
  ``np.random.RandomState``) and ``install_custom_embeddings`` (an a1111
  ``.pt`` and a ``.safetensors`` embedding): the same rows, bit for bit, and
  the same token ids for prompts with the keywords.
* ``clip_text_apply`` with ``trained_extra`` rows below the table: within
  1e-5 of JAX's largest entry (the CLIP tests' bound), and only the ids past
  the table read them.
* The whole slice: both Trainers on one tiny SD1.x directory for 3 uncached
  steps, an optim target with LoRA on the UNet's attention projections and
  1x1 proj_in / proj_out and on CLIP's q / v projections (CLIP-skip 2, so
  the last layer's factors take zero gradients), EMA with a bf16
  shadow (fp32 masters: the high-half dither) and one TI keyword, the JAX
  draws injected (and JAX's initial LoRA A factors, which its PRNG draws).
  Exactly equal: the partition, dtypes, group labels (the ``ti`` group
  included) and the TI rows before training; losses within 1e-5 relative;
  masters and EMA shadows held as ROADMAP difference (j); the checkpoints'
  names, keys, dtypes and metadata (``ema_*``, ``ti_tokens``) equal.
* The CLI with ``--device cpu`` on the same kind of config, LoRA dropout
  0.1 on: saves, and ``--resume`` from a mid-epoch checkpoint ends on the
  continuous run's final checkpoint and sidecar, bit for bit.
"""

import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax.numpy as jnp

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.models import clip as jclip
from scal_sdt_tpu.models import functional as jF
from scal_sdt_tpu.text import bpe as jbpe
from scal_sdt_tpu.text import embeddings as jemb
from scal_sdt_tpu.text import ti as jti
from scal_sdt_tpu.training import optim_targets as jtargets
from scal_sdt_tpu.training.trainer import Trainer as JTrainer
from scal_sdt_tpu.utils import state as jstate

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.cli import train as tcli
from scal_sdt_tpu_torch.convert.from_jax import params_from_jax
from scal_sdt_tpu_torch.models import clip as tclip
from scal_sdt_tpu_torch.models import functional as tF
from scal_sdt_tpu_torch.text import bpe as tbpe
from scal_sdt_tpu_torch.text import embeddings as temb
from scal_sdt_tpu_torch.text import ti as tti
from scal_sdt_tpu_torch.training.trainer import Trainer as TTrainer
from scal_sdt_tpu_torch.utils import state as tstate

from helpers import make_image_dataset
from test_torch_data import write_vocab
from test_torch_trainer import _capture_losses, _check_masters, _port_draws
from torch_port_helpers import rand_unet_params, tiny_model_dir, to_np, to_torch

TI_TOKENS = [{"keyword": "my-cat", "vectors_per_token": 2, "init": "the"},
             {"keyword": "zz-style", "vectors_per_token": 3}]
PROMPTS = ["my-cat sitting", "a photo, zz-style", "my-cat,zz-style and the cat"]


@pytest.fixture(autouse=True)
def _clear_dropout_rates():
    yield
    jF.set_lora_dropout_rates({})
    tF.set_lora_dropout_rates({})


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    d = write_vocab(tmp_path_factory.mktemp("vocab") / "tokenizer")
    return d, len(json.loads((d / "vocab.json").read_text()))


def _tokenizers(vocab_dir):
    return jbpe.CLIPBPETokenizer.from_dir(vocab_dir), tbpe.CLIPBPETokenizer.from_dir(vocab_dir)


def _clip_params(n_vocab: int):
    cfg = jclip.CLIPTextConfig(vocab_size=n_vocab, hidden_size=32, intermediate_size=64,
                               num_hidden_layers=2, num_attention_heads=2)
    return cfg, rand_unet_params(jclip.clip_param_shapes(cfg), seed=1)


def test_setup_ti_training_matches_jax(vocab):
    vocab_dir, n_vocab = vocab
    _, params = _clip_params(n_vocab)
    jtok, ttok = _tokenizers(vocab_dir)
    jspecs = jti.parse_ti_specs({"tokens": TI_TOKENS})
    tspecs = tti.parse_ti_specs({"tokens": TI_TOKENS})
    jout, jmeta = jti.setup_ti_training(params, jtok, jspecs, seed=5)
    tout, tmeta = tti.setup_ti_training(params_from_jax(params, device="cpu"), ttok, tspecs,
                                        seed=5)
    assert tmeta == jmeta == [{"keyword": "my-cat", "n_vectors": 2},
                              {"keyword": "zz-style", "n_vectors": 3}]
    extra = tout[tti.TRAINED_EXTRA_KEY]
    assert extra.dtype == torch.float32 and extra.shape == (5, 32)
    assert np.array_equal(extra.numpy(), jout[jti.TRAINED_EXTRA_KEY])
    np.testing.assert_array_equal(ttok(PROMPTS), jtok(PROMPTS))
    assert int(ttok(PROMPTS).max()) == n_vocab + 4      # the rows past the table
    with pytest.raises(ValueError, match="no tokens"):
        tti.parse_ti_specs({"tokens": []})


def test_export_and_register_for_inference(vocab, tmp_path):
    vocab_dir, _ = vocab
    meta = [{"keyword": "my-cat", "n_vectors": 2}, {"keyword": "zz-style", "n_vectors": 3}]
    extra = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    paths = tti.export_embeddings(extra, meta, tmp_path / "emb")
    assert [p.name for p in paths] == ["my-cat.safetensors", "zz-style.safetensors"]
    back = temb.load_embeddings_dir(tmp_path / "emb")
    assert np.array_equal(back[1].vectors, extra[2:].numpy())
    jtok, ttok = _tokenizers(vocab_dir)
    jti.register_ti_tokens_for_inference(jtok, meta)
    tti.register_ti_tokens_for_inference(ttok, meta)
    np.testing.assert_array_equal(ttok(PROMPTS), jtok(PROMPTS))


def test_install_custom_embeddings_matches_jax(vocab, tmp_path):
    vocab_dir, n_vocab = vocab
    _, params = _clip_params(n_vocab)
    r = np.random.RandomState(6)
    d = tmp_path / "embeddings"
    d.mkdir()
    pt = torch.from_numpy(r.randn(2, 32).astype(np.float32))
    torch.save({"string_to_param": {"*": torch.nn.Parameter(pt)}, "name": "my-cat",
                "step": 100}, d / "my-cat.pt")
    tstate.save_state_dict({"emb_params": torch.from_numpy(r.randn(3, 32).astype(np.float32))},
                           d / "zz-style.safetensors")
    (d / "notes.txt").write_text("not an embedding")
    jembs, tembs = jemb.load_embeddings_dir(d), temb.load_embeddings_dir(d)
    assert [e.keyword for e in tembs] == [e.keyword for e in jembs] == ["my-cat", "zz-style"]
    jtok, ttok = _tokenizers(vocab_dir)
    jout = jemb.install_custom_embeddings(params, jtok, jembs)
    tout = temb.install_custom_embeddings(params_from_jax(params, device="cpu"), ttok, tembs)
    key = temb.TOKEN_EMBEDDING_KEY
    assert tout[key].shape == (n_vocab + 5, 32)
    assert np.array_equal(tout[key].numpy(), jout[key])
    np.testing.assert_array_equal(ttok(PROMPTS), jtok(PROMPTS))
    assert tembs[0].expand_keyword("my-cat, a") == jembs[0].expand_keyword("my-cat, a")


def test_clip_text_apply_with_trained_extra(vocab):
    _, n_vocab = vocab
    cfg, params = _clip_params(n_vocab)
    extra = np.random.RandomState(7).randn(3, 32).astype(np.float32)
    ids = np.random.RandomState(8).randint(0, n_vocab + 3, (2, 77)).astype(np.int32)
    ids[:, 1] = n_vocab + 2
    want = jclip.clip_text_apply({**{k: jnp.asarray(v) for k, v in params.items()},
                                  jti.TRAINED_EXTRA_KEY: jnp.asarray(extra)},
                                 jnp.asarray(ids), cfg)
    tparams = params_from_jax(params, device="cpu")
    textra = torch.from_numpy(extra).requires_grad_(True)
    tcfg = tclip.CLIPTextConfig(**cfg.__dict__)
    got = tclip.clip_text_apply({**tparams, tclip.TRAINED_EXTRA: textra}, torch.from_numpy(ids),
                                tcfg)
    err = float(np.abs(to_np(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())
    assert err <= 1e-5
    got.sum().backward()
    assert textra.grad[2].abs().max() > 0
    # rows no id reads take no gradient
    used = set(ids.ravel().tolist())
    for row in range(3):
        assert bool(textra.grad[row].any()) == (n_vocab + row in used)


# --- the whole slice ------------------------------------------------------------------

LORA = {"rank": 4, "alpha": 4, "dropout": 0.0}
OPTIM_TARGET = {
    "unet": {"targets": [{
        "index": ["down_blocks.0", "mid_block", "up_blocks.1"],
        "recurse_conf": {"lora": LORA, "optimizer": {"lr": 2e-3, "weight_decay": 2e-2}},
        "targets": [{"index": ["attentions"], "targets": [{"targets": [
            {"index": ["transformer_blocks"], "targets": [{"targets": [
                {"index": ["attn1", "attn2"],
                 "targets": [{"index": ["to_q", "to_k", "to_v", "to_out.0"]}]}]}]},
            {"index": ["proj_in", "proj_out"]}]}]}]}]},
    "text_encoder": {"targets": [{
        "index": ["text_model.encoder.layers"],
        "recurse_conf": {"lora": LORA, "optimizer": {"lr": 5e-3, "weight_decay": 2e-3}},
        "targets": [{"targets": [{"index": ["self_attn"],
                                  "targets": [{"index": ["q_proj", "v_proj"]}]}]}]}]},
}
BATCH, IMAGES, RES = 8, 16, 32
LATENTS = (BATCH, RES // 2, RES // 2, 4)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory, vocab):
    """A tiny model dir whose CLIP table is exactly the vocab (so TI ids land
    in trained_extra), 16 images, and the shared config."""
    tmp = tmp_path_factory.mktemp("slice")
    vocab_dir, n_vocab = vocab
    model = tiny_model_dir(tmp / "model", vocab_size=n_vocab)
    write_vocab(model / "tokenizer")
    data = make_image_dataset(tmp, n=IMAGES)
    user = {"model": str(model), "output_dir": str(tmp / "out"), "batch_size": BATCH,
            "seed": 3, "num_workers": 2, "optim_target": OPTIM_TARGET,
            # CLIP-skip drops the last CLIP layer: its LoRA factors take zero
            # gradients (weight decay still moves them), as in JAX
            "clip_stop_at_layer": 2,
            "data": {"resolution": RES, "concepts": [
                {"instance_set": {"path": str(data), "prompt": "my-cat, {TXT_PROMPT}"}}]},
            "ema": {"enabled": True, "dtype": "bf16", "decay": 0.9},
            "custom_embeddings": {"train": {"enabled": True, "lr": 1e-2, "tokens": TI_TOKENS[:1]}},
            "trainer": {"precision": "32", "max_epochs": 2},
            "optimizer": {"params": {"lr": 1e-3}, "lr_scale": {"enabled": False}},
            "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None}}
    return tmp, user


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def test_whole_slice_matches_jax(slice_run, monkeypatch):
    tmp, user = slice_run
    jcfg = jconf.merge(jconf.default(), user,
                       {"trainer": {"mesh": {"data": 8}, "param_packing": False}})
    tcfg = tconf.merge(tconf.default(), tconf.Config(dict(user)))
    jtr = JTrainer(jcfg, tmp / "whole" / "jax")
    ttr = TTrainer(tcfg, tmp / "whole" / "port", device="cpu")

    jnat, tnat = jtr.natural_trainable(), ttr.natural_trainable()
    assert tnat.keys() == jnat.keys() and ttr.frozen.keys() == jtr.frozen.keys()
    # 4 attentions of 8 projections and proj_in / proj_out; 2 CLIP layers of 2
    assert [len(r.lora) for r in ttr.resolutions.values()] == [40, 4]
    n_lora = 44
    assert sum(k.endswith(".lora_alpha") for k in ttr.frozen) == n_lora
    for ours, theirs in ((tnat, jnat), (ttr.frozen, jtr.frozen)):
        for k, v in theirs.items():
            assert _dtype_name(ours[k]) == str(np.asarray(v).dtype), k
    assert ttr.tx.labels == {**jtargets.group_labels(jtr.resolutions),
                             "condition_model.encoder." + tti.TRAINED_EXTRA_KEY: "ti"}
    assert ttr.ti_meta == jtr.ti_meta
    ti_key = "condition_model.encoder." + tti.TRAINED_EXTRA_KEY
    assert torch.equal(tnat[ti_key], to_torch(jnat[ti_key]))
    # JAX's PRNG draws the A factors: the port starts from the same ones
    for k, v in jnat.items():
        if k.endswith(".lora_A"):
            tnat[k].copy_(to_torch(v))
            if k in ttr.state.ema.shadow:
                ttr.state.ema.shadow[k].copy_(to_torch(v))
        assert torch.equal(tnat[k], to_torch(v)), k
    assert ttr.state.ema.shadow.keys() == jtr.state.ema.shadow.keys()
    for k, v in jtr.state.ema.shadow.items():
        assert torch.equal(ttr.state.ema.shadow[k], to_torch(v)), k

    rng0 = np.asarray(jtr.state.rng)
    jlosses, tlosses = _capture_losses(jtr, monkeypatch), _capture_losses(ttr, monkeypatch)
    jtr.fit(max_steps_override=3)
    ttr.fit(max_steps_override=3, draws_fn=_port_draws(rng0, jtr.spec, cached=False))
    assert [s for s, _ in tlosses] == [s for s, _ in jlosses] == [1, 2, 3]
    for (_, t), (_, j) in zip(tlosses, jlosses):
        assert abs(t - j) <= 1e-5 * abs(j), (tlosses, jlosses)

    jnat, tnat = jtr.natural_trainable(), ttr.natural_trainable()
    moved = [k for k in tnat if k.endswith(".lora_B") and tnat[k].any()]
    assert len(moved) == n_lora - 2      # layer 1 of CLIP is skipped
    _check_masters(tnat, jnat, bf16=False, lr=1e-2, steps=3)
    assert ttr.state.ema.num_updates == int(jtr.state.ema.num_updates) == 3
    _check_masters(ttr.state.ema.shadow, jtr.state.ema.shadow, bf16=True, lr=1e-2, steps=3)

    jfiles = sorted(p.name for p in (tmp / "whole" / "jax").glob("*.safetensors"))
    tfiles = sorted(p.name for p in (tmp / "whole" / "port").glob("*.safetensors"))
    assert tfiles == jfiles == ["epoch=1-step=3.safetensors"]
    jpath, tpath = tmp / "whole" / "jax" / jfiles[0], tmp / "whole" / "port" / tfiles[0]
    assert tstate.load_metadata(tpath) == jstate.load_metadata(jpath)
    meta = json.loads(tstate.load_metadata(tpath)["json"])
    assert meta["ti_tokens"] == [{"keyword": "my-cat", "n_vectors": 2}]
    assert meta["ema_num_updates"] == 3
    jfile, tfile = jstate.load_state_dict(jpath), tstate.load_state_dict(tpath)
    assert tfile.keys() == jfile.keys()
    for k, v in jfile.items():
        assert _dtype_name(tfile[k]) == str(v.dtype), k


def _cli(args):
    return CliRunner().invoke(tcli.main, args + ["--device", "cpu"])


def test_cli_lora_ema_ti_saves_and_resumes(slice_run, tmp_path):
    """LoRA (dropout 0.1), a bf16 EMA shadow and TI through the CLI: 3 steps
    with a checkpoint each; --resume from step 2 (mid-epoch) ends on run 1's
    final checkpoint and sidecar bit for bit (EMA shadow and count, TI rows
    and LoRA factors included)."""
    _, user = slice_run
    lora = dict(LORA, dropout=0.1)
    target = json.loads(json.dumps(OPTIM_TARGET).replace(json.dumps(LORA), json.dumps(lora)))
    cfg = dict(user, output_dir=str(tmp_path / "out"), optim_target=target,
               trainer=dict(user["trainer"], max_steps=3, precision="bf16"),
               checkpoint=dict(user["checkpoint"], every_n_train_steps=1))
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps(cfg))
    result = _cli(["--config", str(path), "--run-id", "first"])
    assert result.exit_code == 0, repr(result.exception)
    run = tmp_path / "out" / "SCAL-SDT" / "first"
    names = sorted(p.name for p in run.glob("*.safetensors"))
    assert names == ["epoch=0-step=1.safetensors", "epoch=0-step=2.safetensors",
                     "epoch=1-step=3.safetensors"]
    first = tstate.load_state_dict(run / names[-1])
    assert any(k.startswith("unet_ema.shadow_params.") and k.endswith("lora_A") for k in first)
    assert first["condition_model.encoder." + tti.TRAINED_EXTRA_KEY].shape == (2, 32)

    result = _cli(["--resume", str(run / "epoch=0-step=2.safetensors"), "--run-id", "second"])
    assert result.exit_code == 0, repr(result.exception)
    second = tmp_path / "out" / "SCAL-SDT" / "second"
    for name in ("epoch=1-step=3.safetensors", "epoch=1-step=3.safetensors.torchstate"):
        want, got = (tstate.load_state_dict(d / name, "safetensors") for d in (run, second))
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert tstate.load_metadata(second / names[-1]) == tstate.load_metadata(run / names[-1])
