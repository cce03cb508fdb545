"""The batch-size tuner over every rank of one host, on the CPU.

JAX tunes ``auto_scale_batch_size`` on a host's whole mesh (one process
drives all its devices) and skips it only across hosts; the port runs one
process per card, so rank 0 runs the search and each trial is a world of
the host's ranks (``training/tuner.py`` ``subprocess_trial`` with
``nproc``).

* ``subprocess_trial(nproc=2)`` over a faked launch: the command (torchrun, standalone,
  the probe, the device, the backend, a report directory), the environment
  without the launching world's variables, and the reading of each rank's
  report: all fit, an out-of-memory report on one rank (its peers silent or
  failed in a collective) is no fit, a real error on one rank raises, a
  rank without a report raises, a timeout kills the trial's process group.
* A real world of 2 gloo probe ranks on the tiny model's cache: a batch
  both ranks fit, and a batch the 2 data-parallel ranks do not divide,
  which fails as a non-OOM error (as JAX's probe fails on a batch its data
  axis does not divide).
* The train CLI under ``torch.distributed.run`` on 2 gloo ranks with
  ``power`` from batch 2: rank 0 runs one search (batch 8 runs out of
  memory on probe rank 1 alone, ``tests/torch_probe_capacity.py``), no
  process group exists while the trials run, and both ranks train at the
  pick, 4, on a 2-rank gloo world.
* ``parallel/mesh.py`` ``share_from_rank0``, which carries the run id and
  the pick to every rank through the rendezvous store.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from click.testing import CliRunner

from scal_sdt_tpu_torch.cli import cache as tcache
from scal_sdt_tpu_torch.training import tuner as ttuner

from helpers import make_image_dataset
from test_torch_data import write_vocab
from torch_port_helpers import tiny_model_dir

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent


class _FakePopen:
    """subprocess.Popen of one world trial: writes the ranks' reports of
    ``scenario`` into the command's report directory."""

    scenario: dict = {}
    launches: list = []

    def __init__(self, cmd, stdout, stderr, env, start_new_session):
        assert start_new_session
        _FakePopen.launches.append((cmd, env))
        self.pid, self.returncode, self.killed = 4242, 1, False
        reports = Path(cmd[cmd.index("--report-dir") + 1])
        for rank, report in self.scenario.get("reports", {}).items():
            (reports / f"rank{rank}.json").write_text(json.dumps(report))
        if self.scenario.get("reports") and all(r.get("fits") for r in
                                                self.scenario["reports"].values()):
            self.returncode = 0

    def communicate(self, timeout=None):
        if self.scenario.get("hang") and not self.killed:
            self.killed = True
            raise subprocess.TimeoutExpired("torchrun", timeout)
        return b"", b"torchrun: ChildFailedError ..."


FIT = {"batch_size": 4, "fits": True, "steps": 3, "peak_mem_gib": 1.5}
OOM = {"batch_size": 4, "fits": False, "oom": True,
       "error": "OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB."}
PEER = {"batch_size": 4, "fits": False, "oom": False,
        "error": "RuntimeError: [gloo] Connection closed by peer"}
REAL = {"batch_size": 4, "fits": False, "oom": False,
        "error": "ValueError: a real error"}
SCENARIOS = {  # reports by rank, and what the trial does
    "all_fit": ({0: FIT, 1: dict(FIT, peak_mem_gib=2.0)}, True),
    "oom_on_rank_1": ({1: OOM}, False),
    "oom_and_a_failed_peer": ({0: PEER, 1: OOM}, False),
    "real_error_on_rank_1": ({0: FIT, 1: REAL}, r"non-OOM reason on rank\(s\) \[1\]: "
                                               r"ValueError: a real error"),
    "a_rank_without_report": ({0: FIT}, r"1 of 2 probes wrote no report"),
    "timeout": ({}, False),
}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_world_trial_reads_every_rank(case, monkeypatch, tmp_path):
    reports, want = SCENARIOS[case]
    _FakePopen.scenario = {"reports": reports, "hang": case == "timeout"}
    _FakePopen.launches = []
    killed = []
    monkeypatch.setattr(subprocess, "Popen", _FakePopen)
    monkeypatch.setattr(os, "killpg", lambda pid, sig: killed.append(pid))
    for name, value in {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0", "MASTER_PORT": "29500",
                        "MASTER_ADDR": "localhost", "TORCHELASTIC_RUN_ID": "outer",
                        "TORCHELASTIC_USE_AGENT_STORE": "True", "GROUP_RANK": "0"}.items():
        monkeypatch.setenv(name, value)
    trial = ttuner.subprocess_trial(tmp_path / "cfg.yaml", nproc=2, device="cuda:0",
                                    backend="gloo")
    if isinstance(want, str):
        with pytest.raises(RuntimeError, match=want):
            trial(4)
    else:
        assert trial(4) is want
    (cmd, env), = _FakePopen.launches
    assert cmd[1:6] == ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2"]
    assert cmd[6:8] == ["-m", ttuner.PROBE_MODULE]
    assert cmd[cmd.index("--batch-size") + 1] == "4" and cmd[cmd.index("--device") + 1] == "cuda:0"
    assert cmd[-2:] == ["--backend", "gloo"]
    assert not {k for k in env if k in ttuner.LAUNCH_VARS or k.startswith("TORCHELASTIC_")}
    assert env["PATH"] == os.environ["PATH"]
    (record,) = trial.history
    assert record["batch_size"] == 4 and set(record["ranks"]) == set(reports)
    assert killed == ([4242] if case == "timeout" else [])
    if want is True:
        assert record["peak_mem_gib"] == 2.0 and record["steps"] == 3
    if case.startswith("oom"):
        assert "CUDA out of memory" in record["error"]


@pytest.fixture(scope="module")
def cached_run(tmp_path_factory):
    """A tiny model directory with a vocab, 8 images and their cache (the
    port's cache CLI on the CPU), and a cached training config."""
    tmp = tmp_path_factory.mktemp("tuner_world")
    model = tiny_model_dir(tmp / "model")
    write_vocab(model / "tokenizer")
    data = make_image_dataset(tmp, n=8)
    cfg = {"model": str(model), "output_dir": str(tmp / "out"), "batch_size": 2, "seed": 1,
           "num_workers": 1,
           "data": {"resolution": 32, "cache": str(tmp / "cache.safetensors"), "concepts": [
               {"instance_set": {"path": str(data), "prompt": "{TXT_PROMPT}"}}]},
           "trainer": {"precision": "32", "max_epochs": 4},
           "optimizer": {"params": {"lr": 1e-3}, "lr_scale": {"enabled": False}},
           "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None}}
    path = tmp / "cfg.yaml"
    path.write_text(json.dumps(cfg))
    result = CliRunner().invoke(tcache.main, ["--config", str(path), "--batch-size", "4",
                                              "--aug-group-size", "1", "--device", "cpu"])
    assert result.exit_code == 0, result.output or repr(result.exception)
    return tmp, cfg


def _env() -> dict:
    return dict(ttuner.trial_env(), OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([str(ROOT), str(TESTS)]))


def test_world_trial_on_two_gloo_ranks(cached_run, monkeypatch):
    """Two real probe ranks over gloo: batch 2 (a row each) fits on both,
    2 real steps each; batch 3, which the 2 data-parallel ranks do not
    divide, raises as a non-OOM failure naming the numbers (whichever rank
    reports first: torchrun then stops the other)."""
    tmp, _ = cached_run
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    trial = ttuner.subprocess_trial(tmp / "cfg.yaml", nproc=2, steps=2, timeout=300,
                                    device="cpu")
    assert trial(2) is True
    record = trial.history[0]
    assert sorted(record["ranks"]) == [0, 1] and record["steps"] == 2
    assert all(r["fits"] and r["steps"] == 2 for r in record["ranks"].values())
    with pytest.raises(RuntimeError, match=r"(?s)non-OOM reason on rank\(s\) \[(0|1|0, 1)\]: "
                                           r"ValueError: batch_size 3 is not divisible by the 2 "
                                           r"data-parallel ranks"):
        trial(3)


def test_two_rank_cli_tunes_once_and_trains_every_rank_at_the_pick(cached_run, tmp_path):
    tmp, cfg = cached_run
    cfg = dict(cfg, output_dir=str(tmp_path / "out"),
               trainer=dict(cfg["trainer"], auto_scale_batch_size="power", max_steps=2))
    path = tmp_path / "tune.yaml"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "seen"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           str(TESTS / "torch_tuner_rank.py"), str(out), "--",
           "--config", str(path), "--run-id", "tuned", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(_env(), PROBE_CAPACITY="4"),
                          capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr.decode(errors="replace")[-4000:]
    ranks = [json.loads(Path(f"{out}.rank{r}.json").read_text()) for r in range(2)]
    history = ranks[0]["trials"]
    assert [t["batch_size"] for t in history] == [2, 4, 8]
    assert [t["returncode"] == 0 for t in history] == [True, True, False]
    assert history[2]["ranks"]["1"]["oom"] is True and "error" in history[2]
    assert all(t["steps"] == 3 for t in history[:2])
    assert ranks[0]["group_during_trials"] == [False, False, False]
    assert ranks[1]["trials"] == []
    for r in ranks:
        assert r["batch_size"] == 4 and r["global_step"] == 2
        assert r["world"] == 2 and r["backend"] == "gloo"
    from scal_sdt_tpu_torch import conf as tconf

    assert tconf.load(tmp_path / "out" / "SCAL-SDT" / "tuned" / "config.yaml").batch_size == 4


def test_share_from_rank0_through_the_store():
    """Alone in a world ``make`` runs; over 2 ranks rank 0's value reaches
    rank 1 through the store, rank 0's error reaches it named, and a world
    without the rendezvous store raises."""
    import torch.distributed as dist

    from scal_sdt_tpu_torch.parallel.mesh import LaunchEnv, share_from_rank0

    env = lambda rank, world: LaunchEnv(rank=rank, world=world, local_rank=rank,
                                        local_world=world)
    assert share_from_rank0(None, env(0, 1), "run_id", lambda: "r1") == "r1"
    store = dist.HashStore()
    assert share_from_rank0(store, env(0, 2), "batch_size", lambda: 8) == 8
    assert share_from_rank0(store, env(1, 2), "batch_size", lambda: pytest.fail("rank 1")) == 8

    def fails():
        raise ValueError("no batch fits")
    with pytest.raises(ValueError, match="no batch fits"):
        share_from_rank0(store, env(0, 2), "picked", fails)
    with pytest.raises(RuntimeError, match="rank 0 failed to produce scal_sdt/picked: "
                                           "ValueError: no batch fits"):
        share_from_rank0(store, env(1, 2), "picked", lambda: 1)
    with pytest.raises(RuntimeError, match="needs the rendezvous store"):
        share_from_rank0(None, env(1, 2), "batch_size", lambda: 1)
