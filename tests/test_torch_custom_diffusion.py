"""BASELINE workload 5 on the CPU: Custom Diffusion (the ``custom_diffusion``
optim target: the cross-attention K/V projections only) trained by the
port's Trainer, then ``ckpt_tool prune`` to an fp16 WebUI file, against the
JAX package.

* The target resolves to JAX's leaves, groups and labels over SD1.5's UNet
  (32 leaves, one group each) and the tiny UNet's (8).
* 2 cached steps of the tiny UNet through both packages' Trainers (JAX on
  its 8-device CPU mesh, its draws replayed into the port): the partition
  and the groups exactly, losses within 1e-5 relative, masters within the
  whole-slice bounds of difference (j), the frozen weights untouched, and
  both packages' checkpoints holding only the 8 trained leaves.
* ``ckpt_tool prune --arch sd1 --unet-dtype fp16`` of the port's partial
  checkpoint through both packages' tools: the same keys (the 8 K/V weights
  under ``model.diffusion_model.``), dtypes and bytes, each the trained
  master rounded to fp16.
"""

import numpy as np
import pytest
import torch

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.cli import ckpt_tool as jtool
from scal_sdt_tpu.training import optim_targets as jtargets
from scal_sdt_tpu.training.trainer import Trainer as JTrainer
from scal_sdt_tpu.utils import state as jstate

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.cli import ckpt_tool as ttool
from scal_sdt_tpu_torch.models.unet import UNetConfig, unet_param_shapes
from scal_sdt_tpu_torch.training import optim_targets as ttargets
from scal_sdt_tpu_torch.training.trainer import Trainer as TTrainer
from scal_sdt_tpu_torch.utils import state as tstate

from test_torch_ckpt_tool import assert_same_file, invoke
from test_torch_trainer import (_capture_losses, _check_masters, _configs, _port_draws,
                                tiny_run)  # noqa: F401 - the module fixture
from torch_port_helpers import to_np, to_torch

STEPS = 2


@pytest.mark.parametrize("name,leaves", [("sd15", 32), ("tiny", 8)])
def test_custom_diffusion_target_resolves_as_jax(name, leaves):
    keys = list(unet_param_shapes(getattr(UNetConfig, name)()))
    want = jtargets.resolve_optim_target(jconf.load_optim_target("custom_diffusion"), keys, [])
    got = ttargets.resolve_optim_target(tconf.load_optim_target("custom_diffusion"), keys, [])
    assert got["unet"].trainable == want["unet"].trainable
    assert len(got["unet"].trainable) == leaves
    assert all(".attn2.to_k." in k or ".attn2.to_v." in k for k in got["unet"].trainable)
    assert [(g.keys, dict(g.optimizer)) for g in got["unet"].groups] == \
        [(g.keys, dict(g.optimizer)) for g in want["unet"].groups]
    assert not got["text_encoder"].trainable and not want["text_encoder"].trainable
    assert ttargets.group_labels(got) == jtargets.group_labels(want)


@pytest.fixture(scope="module")
def custom_runs(tiny_run):
    """The tiny model's 2 cached Custom Diffusion steps through both
    Trainers, JAX's draws replayed into the port."""
    tmp, user = tiny_run
    extra = {"optim_target": "custom_diffusion", "trainer": {"max_steps": STEPS}}
    jcfg, tcfg = _configs(user, tmp, extra, cached=True)
    jtr = JTrainer(jcfg, tmp / "custom" / "jax")
    ttr = TTrainer(tcfg, tmp / "custom" / "port", device="cpu")
    base = {k: v.clone() for k, v in ttr.natural_trainable().items()}
    frozen = {k: v.clone() for k, v in ttr.frozen.items()}
    rng0 = np.asarray(jtr.state.rng)
    with pytest.MonkeyPatch.context() as mp:
        jlosses, tlosses = _capture_losses(jtr, mp), _capture_losses(ttr, mp)
        jtr.fit(max_steps_override=STEPS)
        ttr.fit(max_steps_override=STEPS, draws_fn=_port_draws(rng0, jtr.spec, True))
    return tmp, jtr, ttr, base, frozen, jlosses, tlosses


def test_custom_diffusion_trains_as_jax(custom_runs):
    tmp, jtr, ttr, base, frozen, jlosses, tlosses = custom_runs
    jnat, tnat = jtr.natural_trainable(), ttr.natural_trainable()
    assert tnat.keys() == jnat.keys() and len(tnat) == 8
    assert all(k.startswith("unet.") and ".attn2.to_" in k for k in tnat)
    assert ttr.frozen.keys() == jtr.frozen.keys()
    assert ttr.tx.labels == jtargets.group_labels(jtr.resolutions)
    assert [s for s, _ in tlosses] == [s for s, _ in jlosses] == list(range(1, STEPS + 1))
    for (_, t), (_, j) in zip(tlosses, jlosses):
        assert abs(t - j) <= 1e-5 * abs(j), (tlosses, jlosses)
    _check_masters(tnat, jnat, bf16=False, lr=1e-3, steps=STEPS)
    assert all(not torch.equal(tnat[k], base[k]) for k in tnat)
    for k, v in ttr.frozen.items():
        assert torch.equal(v, frozen[k]), k
    for run, nat in ((tmp / "custom" / "jax", jnat), (tmp / "custom" / "port", tnat)):
        (path,) = run.glob("*.safetensors")
        saved = tstate.load_state_dict(path)
        assert saved.keys() == nat.keys()


def test_prune_of_the_partial_checkpoint_to_fp16_matches_jax(custom_runs, tmp_path):
    tmp, _, ttr, *_ = custom_runs
    (ckpt,) = (tmp / "custom" / "port").glob("*.safetensors")
    outs = {}
    for name, main in (("port", ttool.main), ("jax", jtool.main)):
        outs[name] = tmp_path / f"{name}.safetensors"
        invoke(main, ["prune", ckpt, outs[name], "--arch", "sd1", "--unet-dtype", "fp16"])
    got = assert_same_file(outs["port"], outs["jax"])
    assert len(got) == 8
    assert all(k.startswith("model.diffusion_model.") and k.endswith(
        (".attn2.to_k.weight", ".attn2.to_v.weight")) and v.dtype == torch.float16
        for k, v in got.items())
    want = sorted(to_np(v.half()).tobytes() for v in ttr.natural_trainable().values())
    assert sorted(to_np(v).tobytes() for v in got.values()) == want
    assert jstate.load_state_dict(outs["jax"]).keys() == got.keys()
    assert all(torch.equal(to_torch(v), got[k])
               for k, v in jstate.load_state_dict(outs["jax"]).items())
