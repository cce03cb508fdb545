"""Hub ids from the local HF cache and the transformers tokenizer backend,
the port against the JAX package, on the CPU.

* A hub id (``org/name``) in a fabricated cache of the real snapshot layout
  (``tests/test_hub_loading.py``'s ``_fabricate_hf_cache``), found through
  ``HF_HOME`` or ``HF_HUB_CACHE``: the port resolves it to JAX's directory
  without ``huggingface_hub`` and loads JAX's params bit for bit; an
  uncached id and a name that is no hub id raise JAX's errors. The hub is
  held offline throughout.
* ``tokenizer_backend: transformers`` gives JAX's ids for prompts and added
  textual-inversion tokens; a ``vocab.json`` without ``merges.txt`` fails
  as JAX's does; a hub-id model's tokenizer comes from its cached snapshot
  with JAX's ids.
"""

import sys

import numpy as np
import pytest

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.convert import loader as jloader
from scal_sdt_tpu.text import tokenizer as jtok

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.convert import loader as tloader
from scal_sdt_tpu_torch.text import tokenizer as ttok

from test_hub_loading import _fabricate_hf_cache
from test_torch_data import write_vocab
from torch_port_helpers import tiny_model_dir, to_np

REPO_ID = "acme/tiny-sd"
PROMPTS = ["a photo of the cat", "the than of", "", "A Photo, OF the   CAT!",
           "a <sks> photo of <cat-toy>"]


def _offline_cache(monkeypatch, hf_home, via: str) -> None:
    """Point both packages at ``hf_home``'s hub cache, offline. JAX's
    ``huggingface_hub`` and ``transformers`` froze their cache paths and the
    offline switch when first imported, so their constants are patched."""
    import huggingface_hub.constants as hc
    import transformers.utils.hub as th

    cache = str(hf_home / "hub")
    for name in ("HF_HOME", "HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE"):
        monkeypatch.delenv(name, raising=False)
    if via == "HF_HOME":
        monkeypatch.setenv("HF_HOME", str(hf_home))
    else:
        monkeypatch.setenv("HF_HUB_CACHE", cache)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(hc, "HF_HUB_OFFLINE", True)
    for name in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE"):
        monkeypatch.setattr(hc, name, cache, raising=False)
    monkeypatch.setattr(th, "TRANSFORMERS_CACHE", cache, raising=False)


@pytest.fixture(scope="module")
def hub_model(tmp_path_factory):
    """A tiny diffusers directory with a CLIP vocab and merges."""
    d = tiny_model_dir(tmp_path_factory.mktemp("hub") / "model")
    write_vocab(d / "tokenizer")
    return d


@pytest.mark.parametrize("via", ["HF_HOME", "HF_HUB_CACHE"])
def test_hub_id_resolves_from_the_local_cache_as_jax(hub_model, tmp_path, monkeypatch, via):
    hf_home = tmp_path / "hf"
    _fabricate_hf_cache(hf_home, REPO_ID, hub_model)
    _offline_cache(monkeypatch, hf_home, via)
    want = jloader._resolve_hub_id(REPO_ID)
    jm = jloader.load_components(jconf.Config({"model": REPO_ID, "vae": None,
                                               "ldm_config": None}))
    # the port needs no huggingface_hub for a cached id
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    assert tloader._resolve_hub_id(REPO_ID) == want
    assert tloader.cached_snapshot(REPO_ID) == want
    tm = tloader.load_components(tconf.merge(tconf.default(), tconf.Config({"model": REPO_ID})))
    for what in ("unet", "vae", "clip"):
        assert getattr(tm, f"{what}_config").__dict__ == getattr(jm, f"{what}_config").__dict__
        got, ref = getattr(tm, what), getattr(jm, what)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(ref[k]), err_msg=k)


def test_hub_cache_dir_follows_huggingface_hub(tmp_path, monkeypatch):
    for name in ("HF_HOME", "HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "XDG_CACHE_HOME"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tloader.hub_cache_dir() == tmp_path / ".cache" / "huggingface" / "hub"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert tloader.hub_cache_dir() == tmp_path / "xdg" / "huggingface" / "hub"
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    assert tloader.hub_cache_dir() == tmp_path / "home" / "hub"
    monkeypatch.setenv("HUGGINGFACE_HUB_CACHE", str(tmp_path / "old"))
    assert tloader.hub_cache_dir() == tmp_path / "old"
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "new"))
    assert tloader.hub_cache_dir() == tmp_path / "new"
    # a repo directory without refs/main, or naming a missing snapshot, is no hit
    repo = tmp_path / "new" / "models--acme--half"
    (repo / "snapshots").mkdir(parents=True)
    assert tloader.cached_snapshot("acme/half") is None
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("f" * 40)
    assert tloader.cached_snapshot("acme/half") is None
    (repo / "snapshots" / ("f" * 40)).mkdir()
    assert tloader.cached_snapshot("acme/half") == repo / "snapshots" / ("f" * 40)
    assert tloader.cached_snapshot("acme/half/extra") is None


def _error(fn, name):
    with pytest.raises(FileNotFoundError) as info:
        fn(name)
    return str(info.value)


def test_hub_errors_match_jax(tmp_path, monkeypatch):
    """An uncached id: JAX's text, the download's error inside; a name that
    is no hub id: JAX's text; without huggingface_hub an uncached id says
    so in the same sentence."""
    _offline_cache(monkeypatch, tmp_path / "empty_hf", "HF_HOME")
    want = _error(jloader._resolve_hub_id, "acme/does-not-exist")
    got = _error(tloader._resolve_hub_id, "acme/does-not-exist")
    assert "neither a local path, nor in the local HF cache, nor downloadable" in want
    assert got == want
    for name in (str(tmp_path / "missing_dir"), "./rel", "plain"):
        assert _error(tloader._resolve_hub_id, name) == _error(jloader._resolve_hub_id, name)
        assert "is not a hub id" in _error(tloader._resolve_hub_id, name)
    cfg = tconf.merge(tconf.default(), tconf.Config({"model": "acme/does-not-exist"}))
    with pytest.raises(FileNotFoundError, match="neither a local path"):
        tloader.load_components(cfg)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    got = _error(tloader._resolve_hub_id, "acme/does-not-exist")
    assert "nor downloadable (ModuleNotFoundError" in got


# --- the transformers backend ---------------------------------------------------------

def _configs(tmp_path, **kw):
    jcfg = jconf.merge(jconf.default(), jconf.Config(dict(kw, output_dir=str(tmp_path))))
    tcfg = tconf.merge(tconf.default(), tconf.Config(dict(kw, output_dir=str(tmp_path))))
    return jcfg, tcfg


@pytest.mark.parametrize("max_length", [None, 12])
def test_transformers_backend_matches_jax(tmp_path, max_length):
    d = write_vocab(tmp_path / "tok")
    jcfg, tcfg = _configs(tmp_path, tokenizer=str(d), tokenizer_backend="transformers")
    j, t = jtok.resolve_tokenizer(jcfg), ttok.resolve_tokenizer(tcfg)
    assert isinstance(t, ttok.CLIPTokenizerWrapper)
    if max_length:
        j, t = (type(x)(x.tokenizer, max_length=max_length) for x in (j, t))
    assert (t.max_length, t.vocab_size) == (j.max_length, j.vocab_size)
    got = t(PROMPTS)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, j(PROMPTS))
    assert t.add_tokens(["<sks>", "<cat-toy>"]) == j.add_tokens(["<sks>", "<cat-toy>"]) == 2
    assert t.vocab_size == j.vocab_size
    np.testing.assert_array_equal(t(PROMPTS), j(PROMPTS))


def test_vocab_without_merges_fails_as_jax(tmp_path):
    """Only transformers reads a vocab.json without merges.txt, and its slow
    CLIP tokenizer needs the merges: both packages raise the same error."""
    d = write_vocab(tmp_path / "tok")
    (d / "merges.txt").unlink()
    jcfg, tcfg = _configs(tmp_path, tokenizer=str(d))
    with pytest.raises(Exception) as jerr:
        jtok.resolve_tokenizer(jcfg)
    with pytest.raises(Exception) as terr:
        ttok.resolve_tokenizer(tcfg)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


def test_transformers_backend_needs_the_package(tmp_path, monkeypatch):
    d = write_vocab(tmp_path / "tok")
    _, tcfg = _configs(tmp_path, tokenizer=str(d), tokenizer_backend="transformers")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="needs the `transformers` package"):
        ttok.resolve_tokenizer(tcfg)


def test_hub_model_tokenizer_matches_jax(hub_model, tmp_path, monkeypatch):
    """A hub id as ``model``: the tokenizer of its cached snapshot through
    transformers, JAX's ids; without transformers the port falls through to
    the hash stand-in where that is allowed, as JAX's route does."""
    hf_home = tmp_path / "hf"
    _fabricate_hf_cache(hf_home, REPO_ID, hub_model)
    _offline_cache(monkeypatch, hf_home, "HF_HUB_CACHE")
    jcfg, tcfg = _configs(tmp_path, model=REPO_ID)
    j, t = jtok.resolve_tokenizer(jcfg), ttok.resolve_tokenizer(tcfg)
    assert isinstance(j, jtok.CLIPTokenizerWrapper) and isinstance(t, ttok.CLIPTokenizerWrapper)
    np.testing.assert_array_equal(t(PROMPTS), j(PROMPTS))
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert isinstance(ttok.resolve_tokenizer(tcfg, allow_hash=True), ttok.HashTokenizer)
    with pytest.raises(RuntimeError, match="No CLIP tokenizer vocab"):
        ttok.resolve_tokenizer(tcfg)
