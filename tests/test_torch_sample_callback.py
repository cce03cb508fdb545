"""In-training sampling in the port (``training/sample_callback.py``,
``Trainer.merged_inference_params``), on the CPU.

A tiny uncached LoRA run (UNet and CLIP factors in fp32 masters, as
``configs/lora.yaml`` trains them) with ``sampling.concepts`` every 2 steps
writes ``samples/<step>/<concept>-<j>.png`` on those steps only; the images
are what ``sample_images`` makes from the merged frozen + trainable params
with the callback's generator; and the run ends on the same masters and
losses, bit for bit, as the same run without sampling (the callback draws
from no generator of the trainer's and not from torch's global RNG). The
train CLI hands the trainer the callback (``<run_dir>/samples``).
"""

import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.cli import train as tcli
from scal_sdt_tpu_torch.diffusion import sampler as tsampler
from scal_sdt_tpu_torch.models.functional import sub_params
from scal_sdt_tpu_torch.training.sample_callback import SampleCallback
from scal_sdt_tpu_torch.training.trainer import Trainer

from helpers import make_image_dataset
from test_torch_data import write_vocab
from torch_port_helpers import tiny_model_dir

STEPS, INTERVAL = 4, 2
CONCEPTS = [{"prompt": "a photo number 1", "negative_prompt": "blurry", "steps": 2,
             "cfg_scale": 5, "num_samples": 2, "seed": 114514, "width": 32, "height": 32},
            {"prompt": "sks dog", "steps": 2, "num_samples": 1, "seed": 7, "width": 32,
             "height": 32, "method": "euler_a"}]


@pytest.fixture(scope="module")
def run_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sample_callback")
    model = tiny_model_dir(tmp / "model")
    write_vocab(model / "tokenizer")
    data = make_image_dataset(tmp, n=8)
    user = {"model": str(model), "output_dir": str(tmp / "out"), "batch_size": 2, "seed": 3,
            "num_workers": 1, "optim_target": "lora", "clip_stop_at_layer": 2,
            "data": {"resolution": 32, "concepts": [
                {"instance_set": {"path": str(data), "prompt": "{TXT_PROMPT}"}}]},
            "sampling": {"interval_steps": INTERVAL, "batch_size": 1, "concepts": CONCEPTS},
            "trainer": {"precision": "32", "max_epochs": 2, "max_steps": STEPS},
            "optimizer": {"params": {"lr": 1e-3}, "lr_scale": {"enabled": False}},
            "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None}}
    return tmp, user


def _fit(run_setup, tmp_path, sampling: bool):
    _, user = run_setup
    cfg = tconf.merge(tconf.default(), tconf.Config(user))
    if not sampling:
        cfg = tconf.merge(cfg, tconf.Config({"sampling": {"concepts": []}}))
    trainer = Trainer(cfg, tmp_path, device="cpu")
    losses = []
    real = trainer._log
    trainer._log = lambda metrics, step: (losses.append(metrics["train_loss"]),
                                          real(metrics, step))
    snapshots = {}

    def callback(tr, step):
        if step == INTERVAL:   # the params the step-2 samples were made from
            snapshots["merged"] = {k: v.clone() for k, v in tr.merged_inference_params().items()}
        SampleCallback(tmp_path / "samples")(tr, step)

    trainer.fit(sample_callback=callback, final_save=False)
    return trainer, losses, snapshots


def test_callback_samples_on_the_interval_and_leaves_training_alone(run_setup, tmp_path):
    on, losses_on, snap = _fit(run_setup, tmp_path / "on", sampling=True)
    off, losses_off, _ = _fit(run_setup, tmp_path / "off", sampling=False)

    samples = tmp_path / "on" / "samples"
    assert sorted(p.name for p in samples.iterdir()) == ["2", "4"]
    for step in ("2", "4"):
        assert sorted(p.name for p in (samples / step).iterdir()) == ["0-0.png", "0-1.png",
                                                                      "1-0.png"]
    assert not (tmp_path / "off" / "samples").exists()

    # the step-2 images: sample_images on the merged params, one generator
    # per image batch seeded from (concept seed, images so far)
    merged = snap["merged"]
    assert any(k.endswith(".lora_A") for k in merged) and len(merged) > len(on.frozen)
    spec = tsampler.SamplerSpec(unet_config=on.models.unet_config,
                                vae_config=on.models.vae_config,
                                clip_config=on.models.clip_config, schedule=on.models.schedule,
                                clip_stop_at_layer=2)
    c = CONCEPTS[0]
    for j in range(2):
        want = tsampler.sample_images(
            sub_params(merged, "unet"), sub_params(merged, "vae"),
            sub_params(merged, "condition_model.encoder"), on.tokenizer, [c["prompt"]],
            c["negative_prompt"], spec, steps=2, cfg_scale=5.0, width=32, height=32,
            generator=torch.Generator().manual_seed(tsampler.fold_seed(c["seed"], j)),
            device="cpu")
        got = np.asarray(Image.open(samples / "2" / f"0-{j}.png"))
        assert np.array_equal(got, want[0]), j

    # sampling on or off: the same losses and masters, bit for bit
    assert losses_on == losses_off and len(losses_on) == STEPS
    assert on.state.trainable.keys() == off.state.trainable.keys()
    for k, v in off.state.trainable.items():
        assert torch.equal(on.state.trainable[k], v), k
    assert torch.equal(on.state.generator.get_state(), off.state.generator.get_state())


def test_train_cli_samples_into_the_run_dir(run_setup, tmp_path):
    _, user = run_setup
    cfg = dict(user, output_dir=str(tmp_path / "out"),
               trainer=dict(user["trainer"], max_steps=INTERVAL),
               sampling=dict(user["sampling"], concepts=CONCEPTS[1:]))
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps(cfg))
    result = CliRunner().invoke(tcli.main, ["--config", str(path), "--run-id", "r",
                                            "--device", "cpu"])
    assert result.exit_code == 0, repr(result.exception)
    run = tmp_path / "out" / "SCAL-SDT" / "r"
    assert [p.name for p in (run / "samples" / str(INTERVAL)).iterdir()] == ["0-0.png"]
