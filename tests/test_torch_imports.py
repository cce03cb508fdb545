"""The PyTorch port stands alone: importing every module of
scal_sdt_tpu_torch, and chip_smoke.py, loads neither JAX nor the JAX
package, nor optax, flax or msgpack (the card's machine has none of them: the
port reads a JAX ``.trainstate`` with its own msgpack reader); and an entry point asked for the default device raises when there
is no CUDA card instead of running on the CPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import scal_sdt_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "scal_sdt_tpu_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "scal_sdt_tpu_torch."))


def test_every_module_imports_without_jax():
    code = "\n".join([
        "import importlib, sys",
        f"mods = {_modules()!r} + ['chip_smoke']",
        "for m in mods: importlib.import_module(m)",
        "banned = ('jax', 'scal_sdt_tpu', 'optax', 'flax', 'msgpack')",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)",
        "print(len(mods), bad)",
        "sys.exit(1 if bad else 0)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 49
    # the sampling slice's modules, the optimizer slice's, the checkpoint
    # toolchain's and the multi-GPU slice's are among those imported
    assert {"scal_sdt_tpu_torch.diffusion.sampler", "scal_sdt_tpu_torch.convert.kohya",
            "scal_sdt_tpu_torch.cli.sample", "scal_sdt_tpu_torch.cli.gen_class_imgs",
            "scal_sdt_tpu_torch.training.sample_callback", "scal_sdt_tpu_torch.training.families",
            "scal_sdt_tpu_torch.training.packing",
            "scal_sdt_tpu_torch.utils.msgpack", "scal_sdt_tpu_torch.convert.mmdit_names",
            "scal_sdt_tpu_torch.convert.sd_names", "scal_sdt_tpu_torch.cli.ckpt_tool",
            "scal_sdt_tpu_torch.cli.extract_lora", "scal_sdt_tpu_torch.parallel.mesh",
            "scal_sdt_tpu_torch.parallel.sharding", "scal_sdt_tpu_torch.parallel.tensor",
            "scal_sdt_tpu_torch.native.image"} <= set(_modules())


def test_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from) (jax|optax|flax|msgpack)\b|scal_sdt_tpu\.", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{p.relative_to(ROOT)}" for p in files if pattern.search(p.read_text())]
    assert not hits


@pytest.mark.parametrize("entry", ["resolve_device", "init_unet_params", "params_from_jax",
                                   "init_vae_params", "init_clip_params", "to_device",
                                   "Trainer", "train_cli", "sample_images", "sample_cli",
                                   "gen_class_imgs_cli", "lora_approx", "extract_lora_cli"])
def test_default_device_needs_cuda(entry, tmp_path):
    import torch
    from click.testing import CliRunner

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from scal_sdt_tpu_torch.cli import extract_lora, gen_class_imgs, sample
    from scal_sdt_tpu_torch.cli import train as train_cli
    from scal_sdt_tpu_torch.conf import default
    from scal_sdt_tpu_torch.diffusion.sampler import SamplerSpec, sample_images
    from scal_sdt_tpu_torch.diffusion.schedule import NoiseSchedule
    from scal_sdt_tpu_torch.training.trainer import Trainer
    from scal_sdt_tpu_torch.convert.from_jax import params_from_jax
    from scal_sdt_tpu_torch.data.pipeline import to_device
    from scal_sdt_tpu_torch.models.clip import CLIPTextConfig, init_clip_params
    from scal_sdt_tpu_torch.models.unet import UNetConfig, init_unet_params
    from scal_sdt_tpu_torch.models.vae import VAEConfig, init_vae_params

    calls = {"resolve_device": lambda: scal_sdt_tpu_torch.resolve_device(),
             "init_unet_params": lambda: init_unet_params(UNetConfig.tiny()),
             "params_from_jax": lambda: params_from_jax({}),
             "init_vae_params": lambda: init_vae_params(VAEConfig.tiny()),
             "init_clip_params": lambda: init_clip_params(CLIPTextConfig.tiny()),
             "to_device": lambda: to_device({}),
             "Trainer": lambda: Trainer(default(), tmp_path),
             "train_cli": lambda: CliRunner().invoke(train_cli.main, [],
                                                     catch_exceptions=False),
             "sample_images": lambda: sample_images(
                 {}, {}, {}, None, ["a cat"], "", SamplerSpec(
                     UNetConfig.tiny(), VAEConfig.tiny(), CLIPTextConfig.tiny(),
                     NoiseSchedule())),
             "sample_cli": lambda: CliRunner().invoke(
                 sample.main, ["--model", str(tmp_path), "--prompt", "a cat"],
                 catch_exceptions=False),
             "gen_class_imgs_cli": lambda: CliRunner().invoke(
                 gen_class_imgs.main, ["--config", str(config)], catch_exceptions=False),
             "lora_approx": lambda: extract_lora.lora_approx(torch.zeros(2, 2), 1),
             "extract_lora_cli": lambda: CliRunner().invoke(
                 extract_lora.main, [str(config), str(config), str(tmp_path / "o.safetensors")],
                 catch_exceptions=False)}
    config = tmp_path / "cfg.yaml"
    config.write_text("{}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke script exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
