"""DreamBooth class-image generation in the port (``cli/gen_class_imgs.py``)
against the JAX package, on the CPU.

* ``get_size_dist``, ``get_arb_size_dist`` and ``get_delta_dist``: the same
  distributions as the JAX functions on one folder of mixed sizes, with ARB
  buckets from the default config.
* The CLI with ``--device cpu`` on a tiny model directory: it makes the
  shortfall of ``num_target`` at the square resolution, names each PNG by
  the MD5 of its pixels, draws each batch from its own generator (the
  images differ), and a second run over the complete folder makes none.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.cli import gen_class_imgs as jgen

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.cli import gen_class_imgs as tgen

from test_torch_data import write_vocab
from torch_port_helpers import tiny_model_dir

SIZES = [(720, 576), (576, 720), (512, 512), (720, 576), (640, 480), (300, 900)]


def _folder(d: Path, sizes) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    for i, (w, h) in enumerate(sizes):
        Image.new("RGB", (w, h), (i * 20, 10, 30)).save(d / f"img_{i}.png")
    return d


@pytest.mark.parametrize("resolution", [512, 768])
def test_size_distributions_match_jax(tmp_path, resolution):
    d = _folder(tmp_path / "inst", SIZES)
    assert tgen.get_size_dist(d) == jgen.get_size_dist(d)
    (tmp_path / "empty").mkdir()
    assert tgen.get_size_dist(tmp_path / "empty") == jgen.get_size_dist(tmp_path / "empty") == {}
    arb_t = tconf.default().aspect_ratio_bucket
    arb_j = jconf.default().aspect_ratio_bucket
    want = jgen.get_arb_size_dist(d, resolution, arb_j)
    got = tgen.get_arb_size_dist(d, resolution, arb_t)
    assert got == want and abs(sum(got.values()) - 1.0) < 1e-9
    current = {(576, 704): 0.25, (512, 512): 0.5}
    assert tgen.get_delta_dist(current, want) == jgen.get_delta_dist(current, want)


def _config(tmp_path: Path, num_target: int) -> Path:
    model = tiny_model_dir(tmp_path / "model")
    write_vocab(model / "tokenizer")
    inst = _folder(tmp_path / "inst", SIZES[:2])
    cfg = {"model": str(model), "seed": 114514, "clip_stop_at_layer": 2,
           "prior_preservation": {"enabled": True},
           "data": {"resolution": 32, "concepts": [{
               "instance_set": {"path": str(inst), "prompt": "sks 1girl"},
               "class_set": {"path": str(tmp_path / "class"), "prompt": "1girl",
                             "auto_generate": {"enabled": True, "negative_prompt": "lowres",
                                               "steps": 2, "cfg_scale": 11,
                                               "num_target": num_target, "batch_size": 2}}}]}}
    path = tmp_path / "db.yaml"
    path.write_text(json.dumps(cfg))
    return path


def test_gen_class_imgs_fills_the_shortfall_once(tmp_path):
    cfg = _config(tmp_path, num_target=3)
    cls = tmp_path / "class"
    _folder(cls, [(32, 32)])          # one class image already there
    result = CliRunner().invoke(tgen.main, ["--config", str(cfg), "--device", "cpu"])
    assert result.exit_code == 0, repr(result.exception)
    # the folder held 1 of 1 at 32x32: the delta is empty, nothing is made
    assert sorted(p.name for p in cls.iterdir()) == ["img_0.png"]

    (cls / "img_0.png").unlink()
    result = CliRunner().invoke(tgen.main, ["--config", str(cfg), "--device", "cpu"])
    assert result.exit_code == 0, repr(result.exception)
    made = sorted(cls.glob("*.png"))
    assert len(made) == 3
    pixels = [np.asarray(Image.open(p)) for p in made]
    for p, arr in zip(made, pixels):
        assert arr.shape == (32, 32, 3)
        assert p.stem == hashlib.md5(arr.tobytes()).hexdigest()
    # batches of 2 then 1, each from its own generator: three distinct images
    assert len({a.tobytes() for a in pixels}) == 3

    result = CliRunner().invoke(tgen.main, ["--config", str(cfg), "--device", "cpu"])
    assert result.exit_code == 0, repr(result.exception)
    assert sorted(cls.glob("*.png")) == made


def test_gen_class_imgs_needs_prior_preservation_and_a_card(tmp_path):
    cfg = _config(tmp_path, num_target=2)
    data = json.loads(cfg.read_text())
    off = tmp_path / "off.yaml"
    off.write_text(json.dumps(dict(data, prior_preservation={"enabled": False})))
    result = CliRunner().invoke(tgen.main, ["--config", str(off), "--device", "cpu"])
    assert result.exit_code == 0 and not (tmp_path / "class").exists()
    if not torch.cuda.is_available():
        result = CliRunner().invoke(tgen.main, ["--config", str(cfg)])
        assert isinstance(result.exception, RuntimeError) and "CUDA" in str(result.exception)
