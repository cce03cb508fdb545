"""The port's checkpoints against the JAX package's, on the CPU.

* The checkpoint file is shared: for the same parameters and loop state the
  port writes the keys, dtypes, tensors (bit for bit) and metadata JSON that
  the JAX package writes, fp32 and bf16 masters alike. JAX's
  ``restore_train_state`` reads a port checkpoint ("Restored N/N", parameters
  bit-equal, its fresh optimizer state kept: there is no ``.trainstate``);
  the port reads a JAX checkpoint (parameters bit-equal, the step and loop
  state JAX would restore, the optimizer state from its ``.trainstate``, one
  warning that the PRNG key does not carry over); ``ckpt_tool prune`` makes
  the same file from either.
* Exact resume in the port: 3 steps, save mid-epoch, resume in a new
  Trainer, 3 more steps: masters, optimizer state and losses equal a
  continuous 6-step run bit for bit, with AdamW and AdamW8bit. A restore
  copies into the live tensors, so the optimizer's cached leaf table is
  reused (the same object, still holding the state) and stays valid.
* Retention: best-k state persists across managers, files removed out of
  band are dropped, and a pruned checkpoint takes its sidecar with it.
"""

import json
import logging

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax
import jax.numpy as jnp

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.cli import ckpt_tool
from scal_sdt_tpu.models.unet import UNetConfig, unet_param_shapes
from scal_sdt_tpu.training import checkpoint as jckpt
from scal_sdt_tpu.training import optimizers as jopt
from scal_sdt_tpu.training import step as jstep
from scal_sdt_tpu.utils import state as jstate

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.training import checkpoint as tckpt
from scal_sdt_tpu_torch.training import optimizers as topt
from scal_sdt_tpu_torch.training import step as tstep
from scal_sdt_tpu_torch.training.trainer import Trainer as TTrainer
from scal_sdt_tpu_torch.utils import state as tstate

from helpers import make_image_dataset
from test_torch_data import write_vocab
from torch_port_helpers import rand_unet_params, tiny_model_dir, to_torch

LOOP = {"epoch": 1, "batch_in_epoch": 2}
STEP = 5


def _params(dtype):
    """Tiny UNet masters as the trainer keys them, in ``dtype`` (numpy; bf16
    as ml_dtypes)."""
    params = rand_unet_params(unet_param_shapes(UNetConfig.tiny()), prefix="unet.")
    return {k: np.asarray(jnp.asarray(v, dtype)) for k, v in params.items()}


def _opt_config(conf):
    return conf.merge(conf.default(), conf.Config({"optimizer": {"lr_scale": {"enabled": False}}}))


def _port_state(params: dict) -> tstep.TrainState:
    labels = {k: "g0" for k in params}
    tx, _ = topt.build_optimizer(_opt_config(tconf), labels, {}, 10, 1)
    state = tstep.init_train_state({k: to_torch(v) for k, v in params.items()}, tx, seed=0)
    return state._replace(step=STEP)


def _jax_state(params: dict, step: int = 0) -> jstep.TrainState:
    labels = {k: "g0" for k in params}
    tx, _ = jopt.build_optimizer(_opt_config(jconf), labels, {}, 10, 1)
    trainable = {k: jnp.asarray(v) for k, v in params.items()}
    return jstep.TrainState(step=jnp.asarray(step, jnp.int32), trainable=trainable,
                            opt_state=tx.init(trainable), ema=None,
                            rng=jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request, tmp_path_factory):
    """(params, port checkpoint, JAX checkpoint) of the same masters."""
    tmp = tmp_path_factory.mktemp(f"ckpt_{request.param}")
    params = _params(getattr(jnp, request.param))
    tpath, jpath = tmp / "port" / "s.safetensors", tmp / "jax" / "s.safetensors"
    tckpt.save_checkpoint(tpath, _port_state(params), {}, loop_state=LOOP)
    jckpt.save_checkpoint(jpath, _jax_state(params, STEP), {}, loop_state=LOOP)
    return params, tpath, jpath


def test_port_writes_the_jax_file(pair):
    params, tpath, jpath = pair
    assert tstate.load_metadata(tpath) == jstate.load_metadata(jpath)
    assert json.loads(tstate.load_metadata(tpath)["json"]) == {"step": STEP, **LOOP}
    want, got = jstate.load_state_dict(jpath), jstate.load_state_dict(tpath)
    assert got.keys() == want.keys() == params.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype == params[k].dtype, k
        assert np.array_equal(got[k].view(np.uint8), v.view(np.uint8)), k
    assert (tpath.parent / "s.safetensors.torchstate").exists()
    assert not (tpath.parent / "s.safetensors.trainstate").exists()


def test_jax_restores_a_port_checkpoint(pair, caplog):
    params, tpath, _ = pair
    template = _jax_state({k: np.zeros_like(v) for k, v in params.items()})
    with caplog.at_level(logging.INFO, logger="checkpoint"):
        restored = jckpt.restore_train_state(tpath, template)
    n = len(params)
    assert f"Restored {n}/{n} trainable params ({n} tensors on disk)" in caplog.text
    assert "Restored optimizer state" not in caplog.text
    for k, v in params.items():
        got = np.asarray(restored.trainable[k])
        assert got.dtype == v.dtype and np.array_equal(got.view(np.uint8), v.view(np.uint8)), k
    assert int(restored.step) == 0   # the template's: no .trainstate to read
    assert restored.opt_state is template.opt_state


def test_port_restores_a_jax_checkpoint(pair, caplog):
    params, _, jpath = pair
    assert (jpath.parent / "s.safetensors.trainstate").exists()
    template = _port_state({k: np.zeros_like(v) for k, v in params.items()})._replace(step=0)
    tensors = dict(template.trainable)
    with caplog.at_level(logging.INFO, logger="checkpoint"):
        restored = tckpt.restore_train_state(jpath, template)
    n = len(params)
    assert f"Restored {n}/{n} trainable params ({n} tensors on disk)" in caplog.text
    # the JAX sidecar is read (ROADMAP difference (i), repaired): the
    # optimizer state and step come from it, the PRNG key does not carry over
    assert f"Restored the JAX run's optimizer state at step {STEP}" in caplog.text
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "PRNG key does not carry over" in warnings[0].message
    for k, v in params.items():
        assert restored.trainable[k] is tensors[k]   # restored in place
        assert torch.equal(restored.trainable[k], to_torch(v)), k
    assert restored.step == int(json.loads(jstate.load_metadata(jpath)["json"])["step"])
    assert restored.opt_state["g0"].count == 0
    for k, v in params.items():   # JAX's fresh moments, in the masters' dtype
        for m in (restored.opt_state["g0"].mu[k], restored.opt_state["g0"].nu[k]):
            assert m.dtype == to_torch(v).dtype and not m.any(), k
    assert tckpt.load_loop_state(jpath) == jckpt.load_loop_state(jpath) == LOOP


def test_prune_makes_the_same_file_from_either(pair, tmp_path):
    _, tpath, jpath = pair
    outs = []
    for name, src in (("port", tpath), ("jax", jpath)):
        out = tmp_path / f"{name}.safetensors"
        result = CliRunner().invoke(ckpt_tool.main, ["prune", str(src), str(out)])
        assert result.exit_code == 0, result.output or repr(result.exception)
        outs.append(jstate.load_state_dict(out))
    got, want = outs
    assert got.keys() == want.keys() and len(want) == len(pair[0])
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


# --- exact resume in the port ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    model = tiny_model_dir(tmp / "model")
    write_vocab(model / "tokenizer")
    return model, make_image_dataset(tmp, n=16)


def _trainer(tiny_dir, out, optimizer, **trainer):
    model, data = tiny_dir
    cfg = tconf.merge(tconf.default(), tconf.Config({
        "model": str(model), "output_dir": str(out), "batch_size": 8, "seed": 7,
        "num_workers": 2,
        "data": {"resolution": 32, "concepts": [
            {"instance_set": {"path": str(data), "prompt": "{TXT_PROMPT}"}}]},
        "trainer": {"max_epochs": 3, **trainer},
        "optimizer": {"name": optimizer, "master_dtype": "bf16",
                      "params": {"lr": 1e-3}, "lr_scale": {"enabled": False}},
        "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None}}))
    tr = TTrainer(cfg, out, device="cpu")
    tr.losses = []
    real = tr._log
    tr._log = lambda metrics, step: (tr.losses.append(metrics["train_loss"]),
                                     real(metrics, step))
    return tr


def _state_tensors(tr) -> dict:
    tensors, numbers = tckpt.train_state_dict(tr.state)
    tensors.update(tr.state.trainable)
    return {**tensors, **{k: torch.tensor(v) for k, v in numbers.items()}}


@pytest.mark.parametrize("optimizer", ["adamw", "bitsandbytes.optim.AdamW8bit"])
def test_resumed_run_equals_the_continuous_run(tiny_dir, tmp_path, optimizer, monkeypatch):
    """Stop at step 3 (epoch 1, batch 1), resume in a new Trainer, run to 6:
    masters, optimizer state, generator and losses equal a continuous 6-step
    run bit for bit. Uncached, so the latent noise comes from the restored
    generator too; bf16 masters, so the SR store's step is checked. The
    leaves of 1024 elements and more stay out of the JAX trainer's slabs
    (``pack_min_size``), so that AdamW8bit stores them int8, as JAX's
    packed run does."""
    monkeypatch.setenv("SSDT_INT8_FUSED_MIN", "1024")
    continuous = _trainer(tiny_dir, tmp_path / "cont", optimizer, pack_min_size=1024)
    continuous.fit(max_steps_override=6)

    stopped = _trainer(tiny_dir, tmp_path / "split", optimizer, pack_min_size=1024)
    stopped.fit(max_steps_override=3)
    ckpt = tmp_path / "split" / "epoch=1-step=3.safetensors"
    side = tstate.load_state_dict(ckpt.parent / (ckpt.name + ".torchstate"), "safetensors")
    assert {k.split(".")[0] for k in side} == {"opt_state", "generator"}
    assert side["generator"].dtype == torch.uint8

    resumed = _trainer(tiny_dir, tmp_path / "resumed", optimizer, pack_min_size=1024)
    resumed.resume(ckpt)
    assert (resumed.global_step, resumed.epoch_cursor, resumed.batch_in_epoch) == (3, 1, 1)
    resumed.fit(max_steps_override=6)

    assert stopped.losses + resumed.losses == continuous.losses
    want, got = _state_tensors(continuous), _state_tensors(resumed)
    assert got.keys() == want.keys()
    if optimizer != "adamw":
        assert any(".mu_s." in k for k in want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_restore_reuses_the_leaf_table(tiny_dir, tmp_path):
    """A Trainer that has stepped once (the leaf table of its groups' merged
    launch built) and then resumes from another run's step-1 checkpoint
    keeps the same table object, still holding its state's tensors, and its
    next step equals the other run's step 2 bit for bit."""
    ref = _trainer(tiny_dir, tmp_path / "ref", "adamw", max_steps=2)
    ref.ckpt.every_n_train_steps = 1
    ref.fit()
    tr = _trainer(tiny_dir, tmp_path / "tr", "adamw")
    tr.fit(max_steps_override=1, final_save=False)
    (merged,) = tr.tx.merged_launches(tr.state.opt_state, tr.state.trainable)
    table = merged.table
    tr.resume(tmp_path / "ref" / "epoch=0-step=1.safetensors")
    tr.fit(max_steps_override=2, final_save=False)
    assert tr.tx.merged_launches(tr.state.opt_state, tr.state.trainable) == [merged]
    assert merged.table is table
    assert table.holds(*merged.tensors(tr.tx.transforms, tr.state.opt_state, tr.state.trainable))
    want, got = _state_tensors(ref), _state_tensors(tr)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# --- retention ----------------------------------------------------------------------

def _tiny_state() -> tstep.TrainState:
    return _port_state({"unet.conv_in.weight": np.ones((2,), np.float32)})


def test_retention_persists_across_managers(tmp_path):
    cfg = {"filename": "s{step}", "save_top_k": 2, "monitor": "train_loss", "mode": "min",
           "every_n_train_steps": 1}
    state = _tiny_state()
    mgr = tckpt.CheckpointManager(tmp_path, cfg)
    p1 = mgr.save(state, {}, {"step": 1, "train_loss": 0.5})
    p2 = mgr.save(state, {}, {"step": 2, "train_loss": 0.3})
    assert p1.exists() and p2.exists() and (tmp_path / "retention.json").exists()
    # a resumed run's new manager knows the old checkpoints
    p3 = tckpt.CheckpointManager(tmp_path, cfg).save(state, {}, {"step": 3, "train_loss": 0.1})
    assert not p1.exists() and not tckpt.sidecar_path(p1).exists()
    assert p2.exists() and p3.exists() and tckpt.sidecar_path(p3).exists()


def test_retention_ignores_files_removed_out_of_band(tmp_path):
    cfg = {"filename": "s{step}", "save_top_k": 1, "monitor": "train_loss", "mode": "min"}
    mgr = tckpt.CheckpointManager(tmp_path, cfg)
    mgr.save(_tiny_state(), {}, {"step": 1, "train_loss": 0.5}).unlink()
    assert tckpt.CheckpointManager(tmp_path, cfg)._saved == []
