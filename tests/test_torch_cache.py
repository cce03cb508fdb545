"""The port's cache CLI and state-dict IO against the JAX package's.

Both CLIs run on the same tiny diffusers directory, images and config (two
groups, CLIP-BPE ids on a synthetic vocab, stop_at_layer 2), once with the
images through the native decoder (both packages' default: random crops,
no augmentation) and once through PIL (the decoder switched off in both,
flips as augmentation); the
port's runs with ``--device cpu`` and the latent noise replayed from JAX's
draws. The files hold the same keys and the same metadata JSON; latents and
conds agree within 1e-5 of the largest entry (fp32 sums in another order).
Each package's ``LatentCache`` and ``DataPipeline`` read the other's file.
"""

import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax
import jax.numpy as jnp

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.cli import cache as jcache
from scal_sdt_tpu.data import pipeline as jpipeline
from scal_sdt_tpu.utils import state as jstate

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.cli import cache as tcache
from scal_sdt_tpu_torch.data import pipeline as tpipeline
from scal_sdt_tpu_torch.utils import state as tstate

from helpers import make_image_dataset
from test_torch_data import write_vocab
from torch_port_helpers import tiny_model_dir, to_np

SEED = 5


def _jax_latent_noise(seed, device):
    """The JAX CLI's latent draws in its order (split the key once per
    batch), NCHW for the port."""
    rng = [jax.random.PRNGKey(seed)]

    def noise(moments):
        rng[0], sub = jax.random.split(rng[0])
        b, c2, h, w = moments.shape
        n = jax.random.normal(sub, (b, h, w, c2 // 2), jnp.float32)
        return torch.from_numpy(np.asarray(n).transpose(0, 3, 1, 2).copy())

    return noise


@pytest.fixture(scope="module", params=["native", "pil"])
def caches(tmp_path_factory, request):
    """(config dict, JAX cache file, port cache file)."""
    from scal_sdt_tpu.native import image as jnative
    from scal_sdt_tpu_torch.native import image as tnative

    tmp = tmp_path_factory.mktemp("cache")
    model = tiny_model_dir(tmp / "model")
    write_vocab(model / "tokenizer")
    data = make_image_dataset(tmp, n=5, size=(40, 52))
    user = {"model": str(model), "seed": SEED, "clip_stop_at_layer": 2, "num_workers": 2,
            "data": {"resolution": 32,
                     "concepts": [{"instance_set": {"path": str(data),
                                                    "prompt": "{TXT_PROMPT}"}}]}}
    pil = request.param == "pil"
    if pil:
        user["augment"] = [{"name": "RandomHorizontalFlip", "params": {"p": 0.5}}]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        if pil:
            mp.setattr(jnative, "available", lambda: False)
            mp.setattr(tnative, "available", lambda: False)
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp / "jax_cache"))
        mp.setattr(tcache, "latent_noise_source", _jax_latent_noise)
        for name, cli in (("jax", jcache), ("port", tcache)):
            cfg = dict(user, data=dict(user["data"], cache=str(tmp / f"{name}.safetensors")))
            path = tmp / f"{name}.yaml"
            path.write_text(json.dumps(cfg))
            args = ["--config", str(path), "--batch-size", "2", "--aug-group-size", "2"]
            result = CliRunner().invoke(cli.main, args + (["--device", "cpu"]
                                                          if name == "port" else []))
            assert result.exit_code == 0, result.output or repr(result.exception)
            out[name] = tmp / f"{name}.safetensors"
    return user, out["jax"], out["port"]


def test_cache_cli_writes_the_jax_file(caches):
    user, jfile, tfile = caches
    # the cache CLI encodes one group unless the config augments
    groups = 2 if "augment" in user else 1
    jmeta = json.loads(jstate.load_metadata(jfile)["json"])
    tmeta = json.loads(tstate.load_metadata(tfile)["json"])
    assert tmeta == jmeta
    assert jmeta["total_entries"] == 5 and jmeta["aug_group_size"] == groups
    want, got = jstate.load_state_dict(jfile), tstate.load_state_dict(tfile)
    assert got.keys() == want.keys()
    assert {k for k in got if k.endswith(".cond")} == {f"{i}.cond" for i in range(5)}
    for k in want:
        g, w = to_np(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k
    # the two groups differ (flips and latent draws), so both were encoded
    if groups == 2:
        assert not np.array_equal(to_np(got["0.latent.0"]), to_np(got["0.latent.1"]))


def test_each_pipeline_reads_the_other_file(caches):
    """Cached batches over two epochs: the JAX pipeline on the port's file
    and the port's on the JAX file, against the JAX pipeline on its own."""
    user, jfile, tfile = caches
    runs = {}
    for reader, conf, pipeline in (("jax", jconf, jpipeline), ("port", tconf, tpipeline)):
        for name, f in (("jax", jfile), ("port", tfile)):
            cfg = conf.merge(conf.default(), conf.Config(user),
                             conf.Config({"batch_size": 2, "data": {"cache": str(f)}}))
            ds = pipeline.get_dataset(cfg)
            pipe = pipeline.DataPipeline(ds, pipeline.get_sampler(ds, cfg, 1, 0), 2,
                                         num_workers=1)
            runs[reader, name] = [b for _ in range(2) for b in pipe]
    want = runs["jax", "jax"]
    assert len(want) == 4
    for key in (("jax", "port"), ("port", "jax"), ("port", "port")):
        got = runs[key]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["ids"] == w["ids"] and g.keys() == w.keys() == {"ids", "latents", "conds"}
            for k in ("latents", "conds"):
                assert g[k].shape == w[k].shape and g[k].dtype == np.float32
                assert np.abs(g[k] - w[k]).max() <= 1e-5 * np.abs(w[k]).max(), (key, k)
    on_dev = tpipeline.to_device(runs["port", "jax"][0], "cpu")
    assert on_dev["latents"].shape == (2, 4, 16, 16)


def test_cache_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("data:\n  cache: x.safetensors\n")
    result = CliRunner().invoke(tcache.main, ["--config", str(cfg)])
    assert result.exit_code != 0
    assert "CUDA is not available" in str(result.exception)


def test_state_dict_io_matches_jax(tmp_path):
    r = np.random.RandomState(0)
    state = {"a.weight": torch.from_numpy(r.randn(3, 4).astype(np.float32)),
             "a.bias": torch.from_numpy(r.randn(4).astype(np.float32)).bfloat16(),
             "steps": torch.arange(3)}
    meta = tstate.save_json_metadata({"entries": [1, 2]})
    tstate.save_state_dict(state, tmp_path / "s.safetensors", metadata=meta)
    assert tstate.load_metadata(tmp_path / "s.safetensors") == meta
    for f in (tmp_path / "s.safetensors", tmp_path / "s.ckpt"):
        if f.suffix == ".ckpt":
            tstate.save_state_dict(state, f)
        got, want = tstate.load_state_dict(f), jstate.load_state_dict(f)
        assert got.keys() == want.keys() == state.keys()
        for k in state:
            assert torch.equal(got[k], state[k]), (f, k)
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]).astype(
                to_np(got[k]).dtype))
    assert tstate.cast_type(state, "fp16")["a.bias"].dtype == torch.float16
    assert tstate.cast_type(state, "fp16")["steps"].dtype == torch.int64
    assert list(tstate.replace_prefix(state, "a.", "b.")) == ["b.weight", "b.bias"]
    assert tstate.where_prefix(state, "st") == {"steps": state["steps"]}
    with pytest.raises(ValueError, match="Unsupported"):
        tstate.save_state_dict(state, tmp_path / "s.npz")
