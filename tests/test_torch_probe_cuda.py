"""The batch-size probe on a card: a trial at a batch the card can hold
exits 0, one at a batch it cannot hold exits 3 through a real CUDA
out-of-memory error (``training/tuner.py`` ``subprocess_trial``, which runs
``python -m scal_sdt_tpu_torch.cli.probe_batch``).

The tiny UNet trains from a cache of 128x128 fp32 latents, so its level-0
attention runs on the plain path over 16,384 tokens: 2 GiB of fp32 scores
per row and head pair, which 64 rows cannot hold on an 80 GB card.

Skips without a CUDA card. Imports no JAX; where JAX is not installed,
skip the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_probe_cuda.py -m cuda
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from scal_sdt_tpu_torch.cli.cache import assemble_cache
from scal_sdt_tpu_torch.models.clip import CLIPTextConfig, init_clip_params
from scal_sdt_tpu_torch.models.unet import UNetConfig, init_unet_params
from scal_sdt_tpu_torch.models.vae import VAEConfig, init_vae_params
from scal_sdt_tpu_torch.training import tuner
from scal_sdt_tpu_torch.utils.state import save_state_dict

ROOT = Path(__file__).resolve().parents[1]
ROWS, LATENT_HW = 64, 128


def _write_run(tmp: Path) -> Path:
    """A tiny diffusers directory, a cache of ROWS seeded latents and conds,
    and a cached fp32 training config."""
    model = tmp / "model"
    for name, cfg, init in (("unet", UNetConfig.tiny(), init_unet_params),
                            ("vae", VAEConfig.tiny(), init_vae_params),
                            ("text_encoder", CLIPTextConfig.tiny(), init_clip_params)):
        (model / name).mkdir(parents=True)
        save_state_dict(init(cfg, device="cpu"), model / name / "diffusion_pytorch_model.safetensors")
        (model / name / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    (model / "scheduler").mkdir()
    (model / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"num_train_timesteps": 1000, "beta_schedule": "scaled_linear",
         "beta_start": 0.00085, "beta_end": 0.012}))
    gen = torch.Generator().manual_seed(0)
    cache, metadata = assemble_cache({
        "ids": list(range(ROWS)),
        "latents": [torch.randn(ROWS, LATENT_HW, LATENT_HW, 4, generator=gen)],
        "conds": torch.randn(ROWS, 77, 32, generator=gen)})
    save_state_dict(cache, tmp / "cache.safetensors", "safetensors",
                    metadata={"json": json.dumps(metadata)})
    path = tmp / "cfg.yaml"
    path.write_text(json.dumps({
        "model": str(model), "output_dir": str(tmp / "out"), "batch_size": 1, "seed": 0,
        "num_workers": 1, "tokenizer": "hash",
        "data": {"resolution": LATENT_HW * 8, "cache": str(tmp / "cache.safetensors")},
        "trainer": {"precision": "32", "max_epochs": 1}}))
    return path


@pytest.mark.cuda
def test_probe_exits_3_at_a_batch_the_card_cannot_hold(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("the probe's out-of-memory exit needs a CUDA card")
    monkeypatch.chdir(ROOT)
    trial = tuner.subprocess_trial(_write_run(tmp_path), steps=1, timeout=600, device="cuda")
    assert trial(1) is True
    assert trial(ROWS) is False
    fit, oom = trial.history
    assert fit["returncode"] == tuner.PROBE_OK and fit["steps"] == 1
    assert oom["returncode"] == tuner.PROBE_OOM
    assert "CUDA out of memory" in oom["error"], oom
