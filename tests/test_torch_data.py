"""The port's host pipeline against the JAX package's, on the same inputs.

Tokenizers (hash and CLIP-BPE on a synthetic vocab) give equal ids; bucket
assignment and batch order agree for 2 ranks over several epochs; the
datasets give bit-equal pixel arrays and size conds on the native decoder's
path (both packages' default: the port builds its own copy of
``native/ssdt_image.cpp``) and on the PIL path (augmentation on, or the
decoder switched off in both), fixed-size and ARB; the port's build of the
decoder gives the outputs of the JAX package's library bit for bit, PNG and
JPEG, and so does its build for a host without libjpeg / libpng headers
(the headers kept in the package, linked to Pillow's wheel's libraries),
which the decoder falls back to when the Makefile's build fails; samplers
(DreamBooth too) and collated pipeline batches are equal; the
cache reader reads the same arrays; ``to_device`` makes the numpy batch NCHW.
Everything here is exact.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.data import bucket as jbucket
from scal_sdt_tpu.data import datasets as jdatasets
from scal_sdt_tpu.data import pipeline as jpipeline
from scal_sdt_tpu.text import bpe as jbpe
from scal_sdt_tpu.text import tokenizer as jtok
from scal_sdt_tpu.utils.state import save_state_dict as jsave

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.data import bucket as tbucket
from scal_sdt_tpu_torch.data import datasets as tdatasets
from scal_sdt_tpu_torch.data import pipeline as tpipeline
from scal_sdt_tpu_torch.text import bpe as tbpe
from scal_sdt_tpu_torch.text import tokenizer as ttok

MERGES = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("i", "n"),
          ("o", "f</w>"), ("p", "h"), ("ph", "o"), ("pho", "t"), ("phot", "o</w>"),
          ("c", "at</w>"), ("d", "o"), ("do", "g</w>"), ("1", "9"), ("'", "s</w>")]
PROMPTS = ["a photo of the cat", "A PHOTO OF THE DOG, masterpiece", "the dog's 1999 toy",
           "  odd \t spacing\n", "", "café, [brackets] (parens) semi;colon",
           " ".join(["the cat and the dog"] * 30)]


def write_vocab(d):
    """A synthetic CLIP vocab (every byte symbol, its end-of-word form, the
    merges, BOS and EOS) as tests/test_bpe_tokenizer.py builds one."""
    d.mkdir(parents=True, exist_ok=True)
    symbols = list(jbpe.bytes_to_unicode().values())
    vocab = {}
    for s in symbols + [s + "</w>" for s in symbols] + [a + b for a, b in MERGES]:
        vocab[s] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES),
                                  encoding="utf-8")
    return d


def make_images(d, sizes, seed=0):
    """PNG files of the given (w, h) sizes with .txt captions."""
    from PIL import Image

    d.mkdir(parents=True, exist_ok=True)
    r = np.random.RandomState(seed)
    for i, (w, h) in enumerate(sizes):
        Image.fromarray(r.randint(0, 255, (h, w, 3), np.uint8)).save(d / f"img_{i}.png")
        (d / f"img_{i}.txt").write_text(f"a photo of the cat, number {i}, tag {i % 3}")
    return d


def configs(data_dir, **extra):
    """The same config for both packages: defaults, then a dataset of one
    concept (captions from .txt files; class images for DreamBooth), then
    ``extra``, each merged over the last."""
    user = {"seed": 3, "batch_size": 2,
            "data": {"resolution": 32,
                     "concepts": [{"instance_set": {"path": str(data_dir),
                                                    "prompt": "{TXT_PROMPT}"},
                                   "class_set": {"path": str(data_dir),
                                                 "prompt": "a photo"}}]}}
    return tuple(c.merge(c.default(), c.Config(user), c.Config(extra))
                 for c in (jconf, tconf))


SIZES = [(64, 48), (48, 64), (40, 40), (80, 36), (36, 70), (50, 44), (64, 48), (33, 60)]
AUGMENT = [{"name": "RandomRotationWithCrop", "params": {"angle_deg": 10}},
           {"name": "torchvision.transforms.RandomHorizontalFlip", "params": {"p": 0.5}},
           {"name": "ColorJitter", "params": {"brightness": 0.2, "contrast": 0.1,
                                              "saturation": 0.1, "hue": 0.05}}]


def pil_path(monkeypatch):
    """Both packages' datasets decode through PIL (the native decoder off)."""
    from scal_sdt_tpu.native import image as jnative
    from scal_sdt_tpu_torch.native import image as tnative

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def test_both_packages_decode_natively():
    """The compared path is the JAX package's default: its tracked library
    loads here, and the port builds its own."""
    from scal_sdt_tpu.native import image as jnative
    from scal_sdt_tpu_torch.native import image as tnative

    assert jnative.available()
    assert tnative.available(), tnative.build_error
    assert tnative.decoder_name() == "native"


def _decodes_as_jax(tmp_path, fmt, decode, size):
    """``decode`` / ``size`` (a native decoder's ``decode_resize_crop`` and
    ``image_size``) against the JAX package's library at several target
    sizes (JPEG DCT scaling at the small ones) and crop fractions, bit for
    bit."""
    from PIL import Image

    from scal_sdt_tpu.native import image as jnative

    r = np.random.RandomState(1)
    for i, (w, h) in enumerate([(128, 96), (200, 300), (611, 517)]):
        arr = (r.randint(0, 128, (h, w, 3)) + np.linspace(0, 120, w)[None, :, None])
        path = tmp_path / f"t{i}.{fmt}"
        Image.fromarray(arr.astype(np.uint8)).save(path, **({"quality": 90} if fmt == "jpg"
                                                            else {}))
        assert size(path) == jnative.image_size(path) == (w, h)
        for tw, th in [(64, 48), (32, 32), (128, 256), (512, 512)]:
            for fx, fy in [(0.5, 0.5), (0.0, 1.0), (0.37, 0.81)]:
                got = decode(path, tw, th, fx, fy)
                want = jnative.decode_resize_crop(path, tw, th, fx, fy)
                assert got.shape == (th, tw, 3) and got.dtype == np.float32
                np.testing.assert_array_equal(got, want, err_msg=f"{path.name} {tw}x{th}")


@pytest.mark.parametrize("fmt", ["png", "jpg"])
def test_native_decoder_matches_jax(tmp_path, fmt):
    """The port's g++ build of the decoder against the JAX package's library:
    ``decode_resize_crop`` and ``image_size``, bit for bit."""
    from scal_sdt_tpu_torch.native import image as tnative

    _decodes_as_jax(tmp_path, fmt, tnative.decode_resize_crop, tnative.image_size)


def _ctypes_decoder(lib):
    """``decode_resize_crop`` / ``image_size`` over a bound library."""
    import ctypes

    def decode(path, tw, th, fx, fy):
        data = Path(path).read_bytes()
        out = np.empty((th, tw, 3), np.float32)
        assert lib.ssdt_decode_resize_crop(data, len(data), tw, th, fx, fy, out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float))) == 0
        return out

    def size(path):
        data = Path(path).read_bytes()
        w, h = ctypes.c_int(), ctypes.c_int()
        assert lib.ssdt_image_size(data, len(data), ctypes.byref(w), ctypes.byref(h)) == 0
        return w.value, h.value
    return decode, size


@pytest.mark.parametrize("fmt", ["png", "jpg"])
def test_kept_headers_build_against_pillow_matches_jax(tmp_path, fmt):
    """The build for a host without libjpeg / libpng headers: the headers
    kept in the package, Pillow's wheel's libjpeg 62 and libpng16 linked by
    path with an rpath. It loads those libraries and decodes as the JAX
    package's tracked library does, bit for bit."""
    import subprocess

    from scal_sdt_tpu_torch.native import image as tnative

    libs = tnative.pillow_libraries()
    assert libs is not None and "pillow.libs" in str(libs[0])
    build = tnative.kept_headers_build(libs)
    assert build.flags == ("-I", str(tnative.INCLUDE_DIR))
    assert tnative.library_path(build) != tnative.library_path(tnative.SYSTEM_BUILD)
    lib = tnative.load_build(build)
    ldd = subprocess.run(["ldd", str(tnative.library_path(build))], capture_output=True,
                         text=True).stdout
    for p in libs:
        assert f"=> {p}" in ldd, ldd
    _decodes_as_jax(tmp_path, fmt, *_ctypes_decoder(lib))


def test_a_failing_system_build_falls_back_to_the_kept_headers(monkeypatch):
    """Where the Makefile's build fails (a host without the ``-dev``
    packages), the next build is used and the failure is kept."""
    from scal_sdt_tpu_torch.native import image as tnative

    broken = tnative.Build("system", (), ("-lssdt_no_such_library",))
    kept = tnative.kept_headers_build(tnative.pillow_libraries())
    monkeypatch.setattr(tnative, "builds", lambda: [broken, kept])
    for name, value in (("_lib", None), ("_tried", False), ("build_error", ""),
                        ("active_build", "")):
        monkeypatch.setattr(tnative, name, value)
    assert tnative.decoder_name() == "native"
    assert tnative.active_build == "kept-headers+pillow"
    assert tnative.build_error.startswith("system: g++ failed")
    assert "ssdt_no_such_library" in tnative.build_error
    monkeypatch.setattr(tnative, "builds", lambda: [broken])
    for name, value in (("_lib", None), ("_tried", False)):
        monkeypatch.setattr(tnative, name, value)
    assert tnative.decoder_name() == "pil" and tnative.decode_resize_crop("x", 4, 4) is None


def test_a_failed_build_is_not_retried(tmp_path, monkeypatch):
    """A build that fails leaves its error beside its key; a later load of
    it (another process of the host) raises that error without running
    ``g++``, while the other builds still compile."""
    from scal_sdt_tpu_torch.native import image as tnative

    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    broken = tnative.Build("system", (), ("-lssdt_no_such_library",))
    kept = tnative.kept_headers_build(tnative.pillow_libraries())
    compiled = []
    real_compile = tnative._compile

    def counting_compile(out, build=tnative.SYSTEM_BUILD):
        compiled.append(build.name)
        return real_compile(out, build)

    monkeypatch.setattr(tnative, "_compile", counting_compile)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*ssdt_no_such_library"):
            tnative.load_build(broken)
    assert compiled == ["system"]
    assert "ssdt_no_such_library" in tnative.failure_path(broken).read_text()
    assert not tnative.library_path(broken).exists()
    tnative.load_build(kept)
    assert compiled == ["system", "kept-headers+pillow"]
    assert not tnative.failure_path(kept).exists()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return make_images(tmp_path_factory.mktemp("images"), SIZES)


def test_hash_tokenizer_matches_jax():
    np.testing.assert_array_equal(ttok.HashTokenizer()(PROMPTS), jtok.HashTokenizer()(PROMPTS))
    j, t = jtok.HashTokenizer(max_length=12), ttok.HashTokenizer(max_length=12)
    assert j.add_tokens(["<cat-toy>"]) == t.add_tokens(["<cat-toy>"])
    np.testing.assert_array_equal(t(["a <cat-toy> here"]), j(["a <cat-toy> here"]))


def test_bpe_tokenizer_matches_jax(tmp_path):
    d = write_vocab(tmp_path / "tok")
    cfg_j, cfg_t = configs(tmp_path, tokenizer=str(d))
    j, t = jtok.resolve_tokenizer(cfg_j), ttok.resolve_tokenizer(cfg_t)
    assert isinstance(t, tbpe.CLIPBPETokenizer)
    got = t(PROMPTS)
    np.testing.assert_array_equal(got, j(PROMPTS))
    assert got.dtype == np.int32 and got.max() < 49408
    assert t.add_tokens(["<sks>"]) == j.add_tokens(["<sks>"]) == 1
    np.testing.assert_array_equal(t(["a <sks> dog"]), j(["a <sks> dog"]))


def test_tokenizer_resolution_refuses_what_is_not_ported(tmp_path):
    """The fallbacks and refusals as JAX's: ``hash`` on request, an error
    without vocab unless the hash stand-in is allowed, the same for a model
    path that does not exist; every route is ported now, so the
    transformers backend loads (tests/test_torch_hub_tokenizer.py holds its
    ids against JAX's)."""
    _, cfg = configs(tmp_path, tokenizer="hash")
    assert isinstance(ttok.resolve_tokenizer(cfg), ttok.HashTokenizer)
    _, cfg = configs(tmp_path)
    with pytest.raises(RuntimeError, match="No CLIP tokenizer vocab"):
        ttok.resolve_tokenizer(cfg)
    assert isinstance(ttok.resolve_tokenizer(cfg, allow_hash=True), ttok.HashTokenizer)
    cfg_j, cfg = configs(tmp_path, model=str(tmp_path / "absent"))
    for tok, c in ((jtok, cfg_j), (ttok, cfg)):
        with pytest.raises(RuntimeError, match="No CLIP tokenizer vocab"):
            tok.resolve_tokenizer(c)
    _, cfg = configs(tmp_path, tokenizer=str(write_vocab(tmp_path / "v")),
                     tokenizer_backend="transformers")
    assert isinstance(ttok.resolve_tokenizer(cfg), ttok.CLIPTokenizerWrapper)


@pytest.mark.parametrize("world", [1, 2])
def test_bucket_manager_matches_jax(world):
    params = dict(base_res=(512, 512), max_size=768 * 512, dim_range=(256, 1024), divisor=64)
    assert (tbucket.gen_bucket_resolutions(**params)
            == jbucket.gen_bucket_resolutions(**params))
    r = np.random.RandomState(1)
    sizes = {i: (int(r.choice([384, 512, 640, 768, 1024, 300])), int(r.choice([384, 512, 700])))
             for i in range(61)}
    for rank in range(world):
        jm, tm = jbucket.BucketManager(4, 11, world, rank), tbucket.BucketManager(4, 11, world, rank)
        jm.gen_buckets(**params)
        tm.gen_buckets(**params)
        assert tm.put_in(sizes, 0.3) == jm.put_in(sizes, 0.3)
        assert [(b.size, b.ids) for b in tm.buckets] == [(b.size, b.ids) for b in jm.buckets]
        for epoch in (None, None, 5):
            tm.start_epoch(epoch)
            jm.start_epoch(epoch)
            got = list(tm.generator())
            assert got == list(jm.generator()) and len(got) == tm.batch_total


@pytest.mark.parametrize("arb,augment,pil", [(False, False, False), (False, True, False),
                                             (True, False, False), (True, True, False),
                                             (False, False, True)],
                         ids=["fixed", "fixed-aug", "arb", "arb-aug", "fixed-pil"])
def test_dataset_items_match_jax(data_dir, monkeypatch, arb, augment, pil):
    """Native decoding unless augmentation is on (PIL then, in both
    packages); ``fixed-pil`` switches the decoder off in both."""
    if pil:
        pil_path(monkeypatch)
    extra = {"aspect_ratio_bucket": {"enabled": arb}}
    if augment:
        extra["augment"] = AUGMENT
    if arb:
        extra["data"] = {"resolution": 48}
    cfg_j, cfg_t = configs(data_dir, **extra)
    jd, td = jpipeline.get_dataset(cfg_j), tpipeline.get_dataset(cfg_t)
    js, ts = (m.get_sampler(d, c, 1, 0) for m, d, c in ((jpipeline, jd, cfg_j),
                                                       (tpipeline, td, cfg_t)))
    for epoch in (0, 1):
        jd.epoch = td.epoch = js.epoch = ts.epoch = epoch
        jidx, tidx = list(js), list(ts)
        assert [(i.value, i.size) for i in tidx] == [(i.value, i.size) for i in jidx]
        assert len(tidx) >= 6
        for i in tidx:
            got, want = td[i], jd[jdatasets.Index(i.value, i.size)]
            assert got.prompt == want.prompt and got.size_cond == want.size_cond
            assert got.image.dtype == np.float32
            np.testing.assert_array_equal(got.image, want.image)


@pytest.mark.parametrize("arb", [False, True], ids=["fixed", "arb"])
def test_pipeline_batches_match_jax(tmp_path, data_dir, arb):
    """DreamBooth pairs, captions with tag shuffle and dropout, BPE ids:
    every collated batch equal, over two epochs."""
    extra = {"prior_preservation": {"enabled": True},
             "aspect_ratio_bucket": {"enabled": arb},
             "tokenizer": str(write_vocab(tmp_path / "tok")),
             "data": {"caption": {"tag_shuffle": True, "tag_dropout": 0.3, "keep_tokens": 1}}}
    cfg_j, cfg_t = configs(data_dir, **extra)
    runs = []
    for m, tok, cfg in ((jpipeline, jtok, cfg_j), (tpipeline, ttok, cfg_t)):
        ds = m.get_dataset(cfg)
        pipe = m.DataPipeline(ds, m.get_sampler(ds, cfg, 1, 0), 2, tok.resolve_tokenizer(cfg),
                              num_workers=2)
        runs.append([b for _ in range(2) for b in pipe])
    want, got = runs
    assert len(got) == len(want) >= 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["ids"] == w["ids"]
        for k in g:
            if k != "ids":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_latent_cache_reads_the_jax_file(tmp_path):
    r = np.random.RandomState(0)
    tensors, sizes = {}, {}
    for i in range(3):
        for g in range(2):
            tensors[f"{i}.latent.{g}"] = r.randn(4, 6, 4).astype(np.float32)
            sizes[f"{i}.latent.{g}"] = [4, 6, 4]
        tensors[f"{i}.cond"] = r.randn(77, 8).astype(np.float32)
    meta = {"sizes": sizes, "entries": [0, 1, 2], "total_entries": 3, "aug_group_size": 2}
    path = tmp_path / "c.safetensors"
    jsave(tensors, path, metadata={"json": json.dumps(meta)})
    j, t = jdatasets.LatentCache(path), tdatasets.LatentCache(path)
    assert t.metadata == j.metadata and t.latent_size(1) == j.latent_size(1) == (48, 32)
    for i in range(3):
        np.testing.assert_array_equal(t.cond(i), j.cond(i))
        for g in range(2):
            np.testing.assert_array_equal(t.latent(i, g), j.latent(i, g))
    assert t.pooled(0) is None


def test_to_device_makes_batches_nchw():
    r = np.random.RandomState(0)
    batch = {"ids": [3, 1], "images": r.randn(2, 8, 6, 3).astype(np.float32),
             "input_ids": r.randint(0, 99, (2, 77)).astype(np.int32),
             "latents": r.randn(2, 4, 3, 4).astype(np.float32)}
    out = tpipeline.to_device(batch, "cpu")
    assert out["ids"] == [3, 1]
    np.testing.assert_array_equal(out["images"].numpy(), batch["images"].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(out["latents"].numpy(), batch["latents"].transpose(0, 3, 1, 2))
    assert out["images"].is_contiguous() and out["input_ids"].dtype == torch.int32
    np.testing.assert_array_equal(out["input_ids"].numpy(), batch["input_ids"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpipeline.to_device(batch)
