"""The port's last tools against the JAX package's, on the CPU.

* The batch-size tuner (``training/tuner.py``): ``search_batch_size`` tries
  the same batches and picks the same one as JAX's over JAX's capacity
  trials, in both modes and under ``max_trials`` / ``max_bs``;
  ``subprocess_trial`` decides as JAX's does for each of the probe's exits
  (0 fits, 3 OOM, anything else raises), reading the report the probe
  writes with it, and passes the device on; ``tune_batch_size``'s
  settings.
* The probe (``cli/probe_batch.py``): in process with the Trainer's ``fit``
  patched, exit 3 on the card's out-of-memory errors and a re-raise of any
  other; one real probe subprocess on the tiny model with ``--device cpu``.
* ``cli.train``'s tuner hook: the picked batch reaches the Trainer and the
  run's ``config.yaml``; no tuning on ``--resume``; one search over world
  trials on one host of 2 ranks, the pick shared through the rendezvous
  store; JAX's skip and warning on more than one host.
* The FLOP count (``utils/flops.py``): ``train_step_flops`` equal to JAX's
  exactly at the tiny UNet and at SD1.5, and the per-op convention.
* ``text/ensemble.py`` on a tiny CLIP + T5 pair with projections, within the
  port's CLIP and T5 tolerance (1e-5 of the largest output).
* ``cli/arb_debug.py`` prints JAX's text; ``cli/deepdanbooru_label.py``
  formats JAX's tags and, through TensorFlow, writes JAX's captions.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

import jax.numpy as jnp
from jax import lax

from scal_sdt_tpu.cli import arb_debug as jarb
from scal_sdt_tpu.cli import deepdanbooru_label as jddl
from scal_sdt_tpu.models import clip as jclip
from scal_sdt_tpu.models import t5 as jt5
from scal_sdt_tpu.models.unet import UNetConfig as JUNetConfig
from scal_sdt_tpu.text import ensemble as jens
from scal_sdt_tpu.training import tuner as jtuner
from scal_sdt_tpu.utils import flops as jflops

from scal_sdt_tpu_torch.cli import arb_debug as tarb
from scal_sdt_tpu_torch.cli import cache as tcache
from scal_sdt_tpu_torch.cli import deepdanbooru_label as tddl
from scal_sdt_tpu_torch.cli import probe_batch as tprobe
from scal_sdt_tpu_torch.cli import train as tcli
from scal_sdt_tpu_torch.models import clip as tclip
from scal_sdt_tpu_torch.models import t5 as tt5
from scal_sdt_tpu_torch.models.unet import UNetConfig as TUNetConfig
from scal_sdt_tpu_torch.ops import attention as tattention
from scal_sdt_tpu_torch.text import ensemble as tens
from scal_sdt_tpu_torch.training import tuner as ttuner
from scal_sdt_tpu_torch.training.trainer import Trainer as TTrainer
from scal_sdt_tpu_torch.utils import flops as tflops

from helpers import make_image_dataset
from test_torch_data import write_vocab
from torch_port_helpers import rand_unet_params, tiny_model_dir, to_np

ROOT = Path(__file__).resolve().parents[1]
ENSEMBLE_TOL = 1e-5   # of the largest output: the port's CLIP and T5 tests' bound


# --- the tuner's search ---------------------------------------------------------------

def _capacity_trial(capacity, log):
    def trial(bs):
        log.append(bs)
        return bs <= capacity
    return trial


# (capacity, init_bs, mode, max_trials, max_bs): JAX's own cases
# (tests/test_round2b_fixes.py) and the two limits in binsearch mode
SEARCHES = {
    "power-11": (11, 1, "power", 25, None),
    "binsearch-11": (11, 1, "binsearch", 25, None),
    "binsearch-8-from-2": (8, 2, "binsearch", 25, None),
    "binsearch-97-from-3": (97, 3, "binsearch", 25, None),
    "nothing-fits": (0, 1, "power", 25, None),
    "max-trials": (10 ** 9, 1, "power", 3, None),
    "max-bs": (10 ** 9, 4, "power", 25, 16),
    "binsearch-max-trials": (100, 1, "binsearch", 4, None),
    "binsearch-max-bs-fits": (40, 5, "binsearch", 25, 30),
    "init-0": (5, 0, "power", 25, None),
}


@pytest.mark.parametrize("case", list(SEARCHES))
def test_search_batch_size_matches_jax(case):
    capacity, init_bs, mode, max_trials, max_bs = SEARCHES[case]
    tried_j, tried_t = [], []
    want = jtuner.search_batch_size(_capacity_trial(capacity, tried_j), init_bs=init_bs,
                                    mode=mode, max_trials=max_trials, max_bs=max_bs)
    got = ttuner.search_batch_size(_capacity_trial(capacity, tried_t), init_bs=init_bs,
                                   mode=mode, max_trials=max_trials, max_bs=max_bs)
    assert got == want and tried_t == tried_j
    assert tried_t  # every case tries at least one batch


def test_search_refuses_an_unknown_mode():
    for search in (jtuner.search_batch_size, ttuner.search_batch_size):
        with pytest.raises(ValueError, match="Unknown auto_scale_batch_size mode"):
            search(lambda bs: True, mode="linear")


class _FakeRun:
    """subprocess.run of one probe: records the command, returns ``rc``."""

    def __init__(self, rc, stdout=b"", stderr=b""):
        self.rc, self.stdout, self.stderr, self.cmds = rc, stdout, stderr, []

    def __call__(self, cmd, capture_output, timeout):
        self.cmds.append(cmd)
        if self.rc is None:
            raise subprocess.TimeoutExpired(cmd, timeout)
        return subprocess.CompletedProcess(cmd, self.rc, self.stdout, self.stderr)


# what the probe reports beside each exit code (a timeout reports nothing)
PROBE_REPORTS = {0: {"batch_size": 4, "fits": True, "steps": 3, "peak_mem_gib": 1.5},
                 3: {"batch_size": 4, "fits": False, "oom": True,
                     "error": "OutOfMemoryError: CUDA out of memory."},
                 1: {"batch_size": 4, "fits": False, "oom": False,
                     "error": "ValueError: a real error"}}


class _FakePopen:
    """subprocess.Popen of one port probe: writes the report that goes with
    ``rc`` into the command's report directory, exits ``rc`` (None hangs)."""

    def __init__(self, rc):
        self.rc, self.cmds, self.killed = rc, [], []

    def __call__(self, cmd, stdout, stderr, env, start_new_session):
        self.cmds.append(cmd)
        if self.rc in PROBE_REPORTS:
            report_dir = Path(cmd[cmd.index("--report-dir") + 1])
            (report_dir / "rank0.json").write_text(json.dumps(PROBE_REPORTS[self.rc]))
        fake, proc = self, subprocess.CompletedProcess(cmd, self.rc)
        proc.pid = 4242

        def communicate(timeout=None):
            if fake.rc is None and not fake.killed:
                raise subprocess.TimeoutExpired(cmd, timeout)
            return b"", b"Traceback ...\nValueError: a real error"
        proc.communicate = communicate
        return proc


@pytest.mark.parametrize("rc", [0, 3, 1, None])
def test_subprocess_trial_reads_exit_codes_as_jax(rc, monkeypatch, tmp_path):
    """0 fits, 3 is an OOM, a timeout fails the trial, anything else raises
    with the probe's error: JAX's trial reads the exit code, the port's the
    report its probe writes with that exit; the port's probe gets the
    caller's device and a report directory."""
    stdout = b"log line\n" + json.dumps(PROBE_REPORTS.get(rc, {})).encode() + b"\n"
    fake = _FakeRun(rc, stdout=stdout, stderr=b"Traceback ...\nValueError: a real error")
    popen = _FakePopen(rc)
    monkeypatch.setattr(subprocess, "run", fake)
    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr(ttuner.os, "killpg", lambda pid, sig: popen.killed.append(pid))
    cfg = tmp_path / "cfg.yaml"
    results = []
    for trial in (jtuner.subprocess_trial(cfg), ttuner.subprocess_trial(cfg, device="cpu")):
        if rc == 1:
            with pytest.raises(RuntimeError, match="(?s)non-OOM reason.*ValueError: a real error"):
                trial(4)
        else:
            results.append(trial(4))
    assert results == ([] if rc == 1 else [rc == 0] * 2)
    (jcmd,), (tcmd,) = fake.cmds, popen.cmds
    assert jcmd[1:3] == ["-m", "scal_sdt_tpu.cli.probe_batch"]
    assert tcmd[1:3] == ["-m", "scal_sdt_tpu_torch.cli.probe_batch"]
    assert tcmd[3:-2] == jcmd[3:] + ["--device", "cpu"] and tcmd[-2] == "--report-dir"
    assert popen.killed == ([4242] if rc is None else [])
    (record,) = trial.history
    assert record["batch_size"] == 4 and record["returncode"] == rc
    assert record["fits"] is (rc == 0)
    if rc == 0:
        assert record["peak_mem_gib"] == 1.5 and record["steps"] == 3
    if rc == 3:
        assert "CUDA out of memory" in record["error"]


def test_tune_batch_size_settings(monkeypatch, tmp_path):
    """Disabled: the config's batch; ``true`` means power; a string names
    the mode; nothing fitting raises; the device reaches the trials."""
    from scal_sdt_tpu_torch.conf import Config

    calls = []

    def fake_trial(config_path, device="cuda", nproc=1, backend=None):
        calls.append((config_path, device))
        return lambda bs: bs <= 11

    monkeypatch.setattr(ttuner, "subprocess_trial", fake_trial)
    cfg = lambda setting, bs=3: Config({"batch_size": bs,
                                        "trainer": {"auto_scale_batch_size": setting}})
    assert ttuner.tune_batch_size(cfg(False, 7), "unused.yaml") == 7
    assert calls == []
    assert ttuner.tune_batch_size(cfg(True), tmp_path / "c.yaml", device="cpu") == 6
    assert ttuner.tune_batch_size(cfg("power"), tmp_path / "c.yaml") == 6
    assert ttuner.tune_batch_size(cfg("binsearch"), tmp_path / "c.yaml") == 11
    assert calls[0] == (tmp_path / "c.yaml", "cpu") and calls[1][1] == "cuda"
    with pytest.raises(RuntimeError, match="even batch_size=12 does not fit"):
        ttuner.tune_batch_size(cfg("power", 12), tmp_path / "c.yaml")


# --- the probe ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def probe_run(tmp_path_factory):
    """A tiny model directory with a vocab, 8 images and their cache (the
    port's cache CLI on the CPU), and a cached training config."""
    tmp = tmp_path_factory.mktemp("probe")
    model = tiny_model_dir(tmp / "model")
    write_vocab(model / "tokenizer")
    data = make_image_dataset(tmp, n=8)
    cfg = {"model": str(model), "output_dir": str(tmp / "out"), "batch_size": 2, "seed": 1,
           "num_workers": 1,
           "data": {"resolution": 32, "cache": str(tmp / "cache.safetensors"), "concepts": [
               {"instance_set": {"path": str(data), "prompt": "{TXT_PROMPT}"}}]},
           "trainer": {"precision": "32", "max_epochs": 4},
           "optimizer": {"params": {"lr": 1e-3}, "lr_scale": {"enabled": False}},
           "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": 1}}
    path = tmp / "cfg.yaml"
    path.write_text(json.dumps(cfg))
    result = CliRunner().invoke(tcache.main, ["--config", str(path), "--batch-size", "4",
                                              "--aug-group-size", "1", "--device", "cpu"])
    assert result.exit_code == 0, result.output or repr(result.exception)
    return path


# the card's out-of-memory errors (torch's allocator, cuBLAS, cuDNN), and
# errors that name no allocation failure
PROBE_ERRORS = {
    "torch-oom": (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a total capacity of "
        "79.19 GiB of which 3.12 GiB is free."), 3),
    "cublas-alloc": (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
                                  "`cublasCreate(handle)`"), 3),
    "cudnn-alloc": (RuntimeError("cuDNN error: CUDNN_STATUS_ALLOC_FAILED"), 3),
    "shape": (RuntimeError("mat1 and mat2 shapes cannot be multiplied (2x3 and 4x5)"), None),
    "cudnn-unsupported": (RuntimeError("cuDNN error: CUDNN_STATUS_NOT_SUPPORTED"), None),
    "launch": (RuntimeError("CUDA error: an illegal memory access was encountered"), None),
}


@pytest.mark.parametrize("case", list(PROBE_ERRORS))
def test_probe_exit_codes(probe_run, monkeypatch, case):
    """The probe's ``main`` in process with ``Trainer.fit`` raising: exit 3
    (and an OOM report on stdout) only for the card's out-of-memory errors;
    any other error re-raises with its message."""
    error, rc = PROBE_ERRORS[case]
    seen = {}

    def fit(self, max_steps_override=None, final_save=True, **kw):
        seen.update(batch=self.config.batch_size, steps=max_steps_override,
                    final_save=final_save, sampling=self.config.sampling,
                    loggers=dict(self.config.loggers))
        raise error

    monkeypatch.setattr(TTrainer, "fit", fit)
    result = CliRunner().invoke(tprobe.main, ["--config", str(probe_run), "--batch-size", "4",
                                              "--steps", "2", "--device", "cpu"])
    assert seen == {"batch": 4, "steps": 2, "final_save": False, "sampling": None, "loggers": {}}
    if rc == 3:
        assert result.exit_code == 3
        report = json.loads(result.output.strip().splitlines()[-1])
        assert report["fits"] is False and str(error) in report["error"]
    else:
        assert result.exit_code == 1 and result.exception is error
        assert '"fits"' not in result.output


def test_probe_subprocess_fits_on_cpu(probe_run, monkeypatch):
    """One real trial: ``python -m scal_sdt_tpu_torch.cli.probe_batch`` on the
    tiny model with ``--device cpu`` trains 2 steps and exits 0."""
    monkeypatch.chdir(ROOT)
    trial = ttuner.subprocess_trial(probe_run, steps=2, timeout=300, device="cpu")
    assert trial(2) is True
    (record,) = trial.history
    assert record["returncode"] == ttuner.PROBE_OK
    assert record["fits"] is True and record["steps"] == 2 and record["batch_size"] == 2


# --- the train CLI's hook -------------------------------------------------------------

class _StubTrainer:
    batches: list = []

    def __init__(self, config, run_dir, device="cuda", backend=None):
        _StubTrainer.batches.append(int(config.batch_size))

    def resume(self, path):
        pass

    def fit(self, sample_callback=None):
        pass


@pytest.mark.parametrize("setting,picked", [("power", 8), ("binsearch", 11), (True, 8)])
def test_train_cli_tunes_the_batch(setting, picked, tmp_path, monkeypatch, caplog):
    """``--config`` with ``auto_scale_batch_size``: the trials' pick reaches
    the Trainer and the run's config.yaml; ``--resume`` of that run tunes
    nothing; rank 0 of a 2-rank world on one host tunes over world trials of
    2 ranks (the CLI's backend passed on) and shares the pick through the
    rendezvous store before the process group exists; on 2 hosts the tuner
    is skipped with JAX's warning."""
    import torch.distributed as dist

    tried, world_tried = [], []

    def fake_trial(config_path, device="cuda", nproc=1, backend=None):
        (tried if nproc == 1 else world_tried).append((nproc, device, backend))
        return lambda bs: bs <= 11

    monkeypatch.setattr(ttuner, "subprocess_trial", fake_trial)
    monkeypatch.setattr(tcli, "Trainer", _StubTrainer)
    _StubTrainer.batches = []
    cfg = {"output_dir": str(tmp_path / "out"), "batch_size": 2,
           "data": {"cache": str(tmp_path / "cache.safetensors")},
           "trainer": {"auto_scale_batch_size": setting}}
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps(cfg))
    result = CliRunner().invoke(tcli.main, ["--config", str(path), "--run-id", "r1",
                                            "--device", "cpu"])
    assert result.exit_code == 0, repr(result.exception)
    assert _StubTrainer.batches == [picked] and tried == [(1, "cpu", None)]
    run = tmp_path / "out" / "SCAL-SDT" / "r1"
    from scal_sdt_tpu_torch import conf as tconf

    assert tconf.load(run / "config.yaml").batch_size == picked

    ckpt = run / "epoch=0-step=1.safetensors"
    ckpt.write_bytes(b"")
    result = CliRunner().invoke(tcli.main, ["--resume", str(ckpt), "--run-id", "r2",
                                            "--device", "cpu"])
    assert result.exit_code == 0, repr(result.exception)
    assert _StubTrainer.batches == [picked, picked] and tried == [(1, "cpu", None)]

    # rank 0 of two on one host: one search over 2-rank worlds, the pick in the store
    for name, value in {"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2", "RANK": "0",
                        "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(name, value)
    store = dist.HashStore()
    joined = []
    monkeypatch.setattr(tcli, "rendezvous_store", lambda env: store)
    monkeypatch.setattr(tcli, "init_process_group",
                        lambda dev, backend, env, st=None: joined.append((backend, st)))
    result = CliRunner().invoke(tcli.main, ["--config", str(path), "--device", "cpu",
                                            "--backend", "gloo"])
    assert result.exit_code == 0, repr(result.exception)
    assert _StubTrainer.batches == [picked] * 3 and tried == [(1, "cpu", None)]
    assert world_tried == [(2, "cpu", "gloo")] and joined == [("gloo", store)]
    assert json.loads(store.get("scal_sdt/batch_size")) == {"value": picked}
    # ... and rank 1 takes rank 0's pick and run id from the store, trying nothing
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    result = CliRunner().invoke(tcli.main, ["--config", str(path), "--device", "cpu",
                                            "--backend", "gloo"])
    assert result.exit_code == 0, repr(result.exception)
    assert _StubTrainer.batches == [picked] * 4 and len(world_tried) == 1

    # two hosts of 2: JAX's skip and warning, the configured batch
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    store = dist.HashStore()
    with caplog.at_level("WARNING", logger="train"):
        result = CliRunner().invoke(tcli.main, ["--config", str(path), "--run-id", "r4",
                                                "--device", "cpu"])
    assert result.exit_code == 0, repr(result.exception)
    assert _StubTrainer.batches == [picked] * 4 + [2] and len(world_tried) == 1
    assert ("auto_scale_batch_size is single-host only; skipping on a 2-process slice (set "
            "batch_size explicitly for multi-host runs)") in caplog.text


# --- the FLOP count -------------------------------------------------------------------

@pytest.mark.parametrize("name,batch,hw", [("tiny", 2, 16), ("sd15", 8, 64)])
def test_train_step_flops_equal_jax(name, batch, hw):
    """Exactly JAX's count (SD1.5, batch 8, 64^2: 19,278,562,590,720);
    ``FORCE_MATH`` is restored after the trace."""
    want = jflops.train_step_flops(getattr(JUNetConfig, name)(), batch, hw)
    got = tflops.train_step_flops(getattr(TUNetConfig, name)(), batch, hw)
    assert got == want
    if name == "sd15":
        assert got == 19_278_562_590_720
    assert tattention.FORCE_MATH is False


def test_train_step_flops_scale_with_batch():
    one = tflops.train_step_flops(TUNetConfig.tiny(), 1, 16)
    assert tflops.train_step_flops(TUNetConfig.tiny(), 3, 16) == 3 * one
    assert tflops.train_step_flops(TUNetConfig.tiny(), 1, 16, context_len=7) < one


def _meta(*shape):
    return torch.empty(*shape, device="meta")


# one op each, on meta tensors, beside the same op in JAX: products and
# convolutions counted by JAX's formulas, everything else not at all
FLOP_OPS = {
    "linear-3d-bias": (lambda: torch.nn.functional.linear(_meta(2, 5, 7), _meta(3, 7), _meta(3)),
                       lambda: jnp.einsum("blk,nk->bln", jnp.zeros((2, 5, 7)), jnp.zeros((3, 7)))),
    "bmm-4d": (lambda: _meta(2, 4, 6, 8) @ _meta(2, 4, 8, 5),
               lambda: jnp.zeros((2, 4, 6, 8)) @ jnp.zeros((2, 4, 8, 5))),
    "conv-stride-2": (
        lambda: torch.nn.functional.conv2d(_meta(2, 6, 9, 9), _meta(4, 6, 3, 3), stride=2,
                                           padding=1),
        lambda: lax.conv_general_dilated(jnp.zeros((2, 9, 9, 6)), jnp.zeros((3, 3, 6, 4)),
                                         (2, 2), ((1, 1), (1, 1)),
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))),
    "conv-groups": (
        lambda: torch.nn.functional.conv2d(_meta(1, 8, 5, 5), _meta(4, 4, 1, 1), groups=2),
        lambda: lax.conv_general_dilated(jnp.zeros((1, 5, 5, 8)), jnp.zeros((1, 1, 4, 4)),
                                         (1, 1), "VALID", feature_group_count=2,
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))),
    "not-counted": (
        lambda: torch.nn.functional.layer_norm(_meta(2, 5, 8), (8,)).softmax(-1) * 2,
        lambda: jnp.tanh(jnp.zeros((2, 5, 8))).sum()),
}


@pytest.mark.parametrize("op", list(FLOP_OPS))
def test_flop_convention_matches_jax(op):
    tfn, jfn = FLOP_OPS[op]
    got = tflops.count_matmul_conv_flops(tfn)
    assert got == jflops.count_matmul_conv_flops(jfn)
    assert (got == 0) == (op == "not-counted")


def test_peak_table():
    """The H100 SXM's dense bf16 peak, the one copy chip_smoke.py reads."""
    assert tflops.GPU_PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989e12
    import chip_smoke

    assert chip_smoke.PEAK_BF16_FLOPS == tflops.GPU_PEAK_FLOPS["NVIDIA H100 80GB HBM3"]


# --- ensemble encoding ----------------------------------------------------------------

PROJ_DIM = 48


def _ensemble_inputs():
    clip_kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=2, max_position_embeddings=16)
    jcc, tcc = jclip.CLIPTextConfig(**clip_kw), tclip.CLIPTextConfig(**clip_kw)
    jtc, ttc = jt5.T5Config.tiny(), tt5.T5Config.tiny()
    proj = lambda d: {"projection.0.weight": (PROJ_DIM, d), "projection.1.weight": (PROJ_DIM,),
                      "projection.1.bias": (PROJ_DIM,)}
    clip_np = rand_unet_params({**jclip.clip_param_shapes(jcc), **proj(jcc.hidden_size)}, 1)
    t5_np = rand_unet_params({**jt5.t5_param_shapes(jtc), **proj(jtc.d_model)}, 2)
    rng = np.random.RandomState(3)
    clip_ids = rng.randint(0, 64, (2, 8)).astype(np.int32)
    t5_ids = rng.randint(0, jtc.vocab_size, (2, 12)).astype(np.int32)
    return (jcc, tcc, jtc, ttc, clip_np, t5_np, lambda p: clip_ids, lambda p: t5_ids)


def test_encode_ensemble_matches_jax():
    jcc, tcc, jtc, ttc, clip_np, t5_np, tok_clip, tok_t5 = _ensemble_inputs()
    jp = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    tp = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    want = jens.encode_ensemble([
        jens.EncoderEntry(jp(clip_np), lambda p, ids: jclip.clip_text_apply(
            p, ids, jcc, stop_at_layer=2), tok_clip, projection_prefix="projection"),
        jens.EncoderEntry(jp(t5_np), lambda p, ids: jt5.t5_encoder_apply(p, ids, jtc),
                          tok_t5, projection_prefix="projection")], ["a", "b"])
    got = tens.encode_ensemble([
        tens.EncoderEntry(tp(clip_np), lambda p, ids: tclip.clip_text_apply(
            p, ids, tcc, stop_at_layer=2), tok_clip, projection_prefix="projection"),
        tens.EncoderEntry(tp(t5_np), lambda p, ids: tt5.t5_encoder_apply(p, ids, ttc),
                          tok_t5, projection_prefix="projection")], ["a", "b"])
    assert tuple(got.shape) == tuple(want.shape) == (2, 8 + 12, PROJ_DIM)
    want = np.asarray(want)
    err = np.abs(to_np(got) - want).max() / np.abs(want).max()
    assert err <= ENSEMBLE_TOL, err


def test_encode_ensemble_refuses_mixed_widths():
    _, tcc, _, ttc, clip_np, t5_np, tok_clip, tok_t5 = _ensemble_inputs()
    tp = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    entries = [tens.EncoderEntry(tp(clip_np), lambda p, ids: tclip.clip_text_apply(p, ids, tcc),
                                 tok_clip, projection_prefix="projection"),
               tens.EncoderEntry(tp(t5_np), lambda p, ids: tt5.t5_encoder_apply(p, ids, ttc),
                                 tok_t5)]
    with pytest.raises(ValueError, match="disagree on width"):
        tens.encode_ensemble(entries, ["a", "b"])


# --- arb_debug ------------------------------------------------------------------------

@pytest.mark.parametrize("resolution,width,height,listing", [
    (512, 512, 512, True), (512, 1920, 1080, False), (512, 600, 2000, False),
    (768, 1000, 750, True), (768, 333, 777, False)])
def test_arb_debug_prints_jax_text(resolution, width, height, listing, tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps({"data": {"resolution": resolution}}))
    args = ["--config", str(path), "--width", str(width), "--height", str(height)]
    args += ["--list-buckets"] if listing else []
    outs = [CliRunner().invoke(m.main, args) for m in (jarb, tarb)]
    assert [r.exit_code for r in outs] == [0, 0], [repr(r.exception) for r in outs]
    assert outs[1].output == outs[0].output
    assert ("Bucket set" in outs[1].output) == listing


# --- deepdanbooru_label ---------------------------------------------------------------

TAGS = ["long_hair", "rating:safe", "smile", "solo_(artist)", "1girl", "a\\b_c"]


@pytest.mark.parametrize("flags", [(False, True, True, False), (True, False, False, False),
                                   (False, True, True, True), (True, True, False, True)])
def test_format_tags_matches_jax(flags):
    probs = np.random.RandomState(4).rand(len(TAGS))
    for threshold in (0.0, 0.3, 0.7):
        assert (tddl.format_tags(TAGS, probs, threshold, *flags)
                == jddl.format_tags(TAGS, probs, threshold, *flags))


class _StubModel:
    input_shape = (None, 16, 16, 3)

    def predict(self, batch, verbose=0):
        # depends on the image, so a wrong preprocess shows
        m = float(np.asarray(batch).mean())
        return np.array([[0.9, 0.99, m, 0.2 + m, 0.7, 0.55]], np.float32)


def _write_images(d: Path):
    d.mkdir()
    Image.new("RGB", (24, 12), (10, 200, 30)).save(d / "x.png")
    Image.new("RGB", (8, 8), (0, 0, 255)).save(d / "y.jpg")
    Image.new("L", (10, 20), 77).save(d / "z.png")
    (d / "y.txt").write_text("preexisting caption")
    return d


def _captions(d: Path) -> dict:
    return {p.name: p.read_text() for p in sorted(d.glob("*.txt"))}


def test_deepdanbooru_cli_writes_jax_captions_with_a_stub(tmp_path, monkeypatch):
    """The file walk, skips and --overwrite of both CLIs over one stub model
    and JAX's TF-free stand-in preprocess."""
    from test_deepdanbooru import _stub_preprocess

    project = tmp_path / "project"
    project.mkdir()
    (project / "project.json").write_text("{}")
    out = {}
    for name, mod in (("jax", jddl), ("torch", tddl)):
        monkeypatch.setattr(mod, "load_model", lambda p: (_StubModel(), TAGS))
        monkeypatch.setattr(mod, "_preprocess", _stub_preprocess)
        d = _write_images(tmp_path / name)
        for extra in ([], ["--overwrite", "--include-ranks", "--alpha-sort"]):
            result = CliRunner().invoke(mod.main, [str(d), "--model-path", str(project)] + extra)
            assert result.exit_code == 0, repr(result.exception)
            out.setdefault(name, []).append(_captions(d))
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["y.txt"] == "preexisting caption"


def test_deepdanbooru_tf_leg_matches_jax(tmp_path):
    """The real TensorFlow path: a tiny Keras tagger saved in the project
    layout, loaded and run by both CLIs (AREA resize with aspect kept, the
    centre pad), writing the same captions. Skips without TensorFlow, as
    the JAX package's test does."""
    tf = pytest.importorskip("tensorflow")
    H = W = 16
    tf.keras.utils.set_random_seed(0)
    model = tf.keras.Sequential([
        tf.keras.layers.Input(shape=(H, W, 3)),
        tf.keras.layers.Conv2D(4, 3, padding="same", activation="relu"),
        tf.keras.layers.GlobalAveragePooling2D(),
        tf.keras.layers.Dense(len(TAGS), activation="sigmoid"),
    ])
    project = tmp_path / "project"
    project.mkdir()
    model.save(project / "model-resnet_custom_tiny.keras")
    (project / "project.json").write_text(json.dumps({"image_width": W, "image_height": H}))
    (project / "tags.txt").write_text("\n".join(TAGS) + "\n")
    out = {}
    for name, mod in (("jax", jddl), ("torch", tddl)):
        d = _write_images(tmp_path / name)
        result = CliRunner().invoke(mod.main, [str(d), "--model-path", str(project),
                                               "--threshold", "0.3", "--include-ranks",
                                               "--overwrite"], catch_exceptions=False)
        assert result.exit_code == 0, result.output
        out[name] = _captions(d)
    assert out["torch"] == out["jax"]
    assert len(out["torch"]) == 3 and any(out["torch"].values())


def test_deepdanbooru_without_tensorflow_raises(tmp_path, monkeypatch):
    (tmp_path / "project.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    for mod in (jddl, tddl):
        with pytest.raises(ImportError):
            mod.load_model(tmp_path)
    with pytest.raises(ImportError, match="needs the `tensorflow` package"):
        tddl.load_model(tmp_path)
