"""The PyTorch port stands alone: importing every module of
scal_sdt_tpu_torch, and chip_smoke.py, loads neither JAX nor the JAX
package; and an entry point asked for the default device raises when there
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
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')",
        "             or m == 'scal_sdt_tpu' or m.startswith('scal_sdt_tpu.'))",
        "print(len(mods), bad)",
        "sys.exit(1 if bad else 0)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 15


def test_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)|scal_sdt_tpu\.", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{p.relative_to(ROOT)}" for p in files if pattern.search(p.read_text())]
    assert not hits


@pytest.mark.parametrize("entry", ["resolve_device", "init_unet_params", "params_from_jax"])
def test_default_device_needs_cuda(entry):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from scal_sdt_tpu_torch.convert.from_jax import params_from_jax
    from scal_sdt_tpu_torch.models.unet import UNetConfig, init_unet_params

    calls = {"resolve_device": lambda: scal_sdt_tpu_torch.resolve_device(),
             "init_unet_params": lambda: init_unet_params(UNetConfig.tiny()),
             "params_from_jax": lambda: params_from_jax({})}
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
