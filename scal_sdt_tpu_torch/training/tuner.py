"""Auto batch-size tuning (port of ``scal_sdt_tpu/training/tuner.py``).

Each trial runs in a SUBPROCESS, ``python -m scal_sdt_tpu_torch.cli.probe_batch``:
a fresh CUDA context trains a few real steps at the trial's batch size. An
in-process trial would leave the allocator's cache and a rolled-back state
behind, and could not undo what an out-of-memory error leaves in a cuBLAS
or cuDNN handle. The search is the JAX package's (Lightning's modes):
``power`` doubles until a failure and keeps the last success;
``binsearch`` then bisects the failure interval.

On N ranks of one host, a trial is a world of its own: ``python -m
torch.distributed.run --standalone --nproc_per_node N -m
scal_sdt_tpu_torch.cli.probe_batch ...`` on the run's mesh. Every trial
starts without the launching world's torchrun variables, so its probes
cannot join that world, and reads each probe's report file, not an exit
code (torchrun turns one rank's exit into its own failure and ends the
others): an out-of-memory report on any rank means the batch does not fit,
even where a peer then failed in a collective; any other error raises;
every probe must report a fit. A trial that outlives its timeout is
killed, world and all.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

logger = logging.getLogger("tuner")

# exit codes of cli/probe_batch.py
PROBE_OK = 0
PROBE_OOM = 3
# the module a trial runs
PROBE_MODULE = "scal_sdt_tpu_torch.cli.probe_batch"
# the launching world's variables (torchrun's and its agent's), which a
# trial's own world must not inherit
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
               "GROUP_WORLD_SIZE", "ROLE_RANK", "ROLE_WORLD_SIZE", "ROLE_NAME", "MASTER_ADDR",
               "MASTER_PORT")


def search_batch_size(trial: Callable[[int], bool], init_bs: int = 1,
                      mode: str = "power", max_trials: int = 25,
                      max_bs: Optional[int] = None) -> int:
    """Largest batch size for which ``trial`` succeeds.

    Pure search logic (an injected ``trial`` keeps it testable without a
    device). Returns 0 if even ``init_bs`` fails.
    """
    if mode not in ("power", "binsearch"):
        raise ValueError(f"Unknown auto_scale_batch_size mode: {mode!r}")

    best = 0
    bs = max(int(init_bs), 1)
    failed_at: Optional[int] = None
    for _ in range(max_trials):
        if max_bs is not None and bs > max_bs:
            break
        logger.info(f"Batch-size probe: trying {bs}")
        if trial(bs):
            best = bs
            bs *= 2
        else:
            failed_at = bs
            break

    if mode == "binsearch" and failed_at is not None and best > 0:
        lo, hi = best, failed_at  # lo succeeded, hi failed
        while hi - lo > 1:
            mid = (lo + hi) // 2
            logger.info(f"Batch-size probe (bisect): trying {mid}")
            if trial(mid):
                lo = mid
            else:
                hi = mid
        best = lo
    return best


def trial_env() -> dict[str, str]:
    """This process's environment without the launching world's variables."""
    return {k: v for k, v in os.environ.items()
            if k not in LAUNCH_VARS and not k.startswith("TORCHELASTIC_")}


def _rank_reports(report_dir: Path) -> dict[int, dict]:
    out = {}
    for path in report_dir.glob("rank*.json"):
        try:
            out[int(path.stem[4:])] = json.loads(path.read_text())
        except (ValueError, OSError):
            continue
    return out


def subprocess_trial(config_path: Path, steps: int = 3, timeout: int = 900,
                     device: str = "cuda", nproc: int = 1,
                     backend: Optional[str] = None) -> Callable[[int], bool]:
    """Trial runner executing ``probe_batch`` in fresh processes: one on
    ``device``, or with ``nproc`` > 1 a world of that many ranks of this
    host (torchrun, standalone), each on its device of ``device``, over
    ``backend`` when given. Each probe writes its report to a directory the
    trial names. The returned function keeps one record per trial in its
    ``history`` list: batch size, the exit code (the probe's, or
    torchrun's), seconds, the reports by rank, and the peak memory and
    steps of a fit or the error text of an OOM."""
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc)] if nproc > 1 else [sys.executable])

    def trial(bs: int) -> bool:
        with tempfile.TemporaryDirectory(prefix="probe_reports_") as reports:
            cmd = [*launch, "-m", PROBE_MODULE,
                   "--config", str(config_path), "--batch-size", str(bs), "--steps", str(steps),
                   "--device", str(device), "--report-dir", reports]
            if backend:
                cmd += ["--backend", str(backend)]
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    env=trial_env(), start_new_session=True)
            try:
                _, stderr = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)   # the probe, or torchrun and its ranks
                proc.communicate()
                logger.warning(f"Batch-size probe at {bs} timed out; treating as failure")
                trial.history.append({"batch_size": bs, "returncode": None,
                                      "seconds": time.perf_counter() - t0, "timed_out": True,
                                      "fits": False, "ranks": _rank_reports(Path(reports))})
                return False
            ranks = _rank_reports(Path(reports))
        record = {"batch_size": bs, "returncode": proc.returncode,
                  "seconds": time.perf_counter() - t0, "fits": False, "ranks": ranks}
        trial.history.append(record)
        text = stderr.decode(errors="replace")
        # a rank's own traceback first (torchrun's summary follows it), then the end
        first = text.find("Traceback (most recent call last)")
        tail = (text[first:first + 3000] + "\n...\n" if first >= 0 else "") + text[-1500:]
        oom = sorted(r for r, rep in ranks.items() if rep.get("oom"))
        if oom:
            record["error"] = ranks[oom[0]].get("error", "")
            logger.info(f"Batch size {bs}: out of memory on rank(s) {oom} "
                        f"({record['error'][:200]})")
            return False
        errors = {r: rep.get("error", "") for r, rep in sorted(ranks.items())
                  if not rep.get("fits")}
        if errors:
            raise RuntimeError(
                f"Batch-size probe at {bs} failed for a non-OOM reason on rank(s) "
                f"{sorted(errors)}: {next(iter(errors.values()))[:2000]}\n{tail}")
        if len(ranks) < nproc:
            raise RuntimeError(
                f"Batch-size probe at {bs}: {nproc - len(ranks)} of {nproc} probes wrote no "
                f"report (rc={proc.returncode}):\n{tail}")
        record["fits"] = True
        record["peak_mem_gib"] = max((rep.get("peak_mem_gib", float("nan"))
                                      for rep in ranks.values()), default=float("nan"))
        record["steps"] = min(int(rep.get("steps", 0)) for rep in ranks.values())
        logger.info(f"Batch size {bs}: fits on {nproc} rank(s) ({record['seconds']:.1f} s, peak "
                    f"{record['peak_mem_gib']:.2f} GiB per rank)")
        return True

    trial.history = []
    return trial


def tune_batch_size(config, config_path: Path, device: str = "cuda", nproc: int = 1,
                    backend: Optional[str] = None) -> int:
    """Resolve ``trainer.auto_scale_batch_size`` into a concrete batch size
    and return it (``true`` means ``power``; the caller skips it on resume).
    ``nproc`` > 1: the trials are worlds of that many ranks of this host
    and the batch is the host's."""
    setting = config.trainer.get("auto_scale_batch_size", False)
    if not setting:
        return int(config.batch_size)
    mode = setting if isinstance(setting, str) else "power"
    trial = subprocess_trial(Path(config_path), device=device, nproc=nproc, backend=backend)
    best = search_batch_size(trial, init_bs=int(config.batch_size), mode=mode)
    if best <= 0:
        raise RuntimeError(
            f"Auto batch-size tuning: even batch_size={config.batch_size} "
            f"does not fit in device memory")
    logger.info(f"Auto batch-size tuning selected batch_size={best}")
    return best
