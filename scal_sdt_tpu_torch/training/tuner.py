"""Auto batch-size tuning (port of ``scal_sdt_tpu/training/tuner.py``).

Each trial runs in a SUBPROCESS, ``python -m scal_sdt_tpu_torch.cli.probe_batch``:
a fresh CUDA context trains a few real steps at the trial's batch size, and
the parent reads only its exit code. An in-process trial would leave the
allocator's cache and a rolled-back state behind, and could not undo what an
out-of-memory error leaves in a cuBLAS or cuDNN handle. The search is the
JAX package's (Lightning's modes): ``power`` doubles until a failure and
keeps the last success; ``binsearch`` then bisects the failure interval.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

logger = logging.getLogger("tuner")

# exit codes of cli/probe_batch.py
PROBE_OK = 0
PROBE_OOM = 3


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


def _probe_report(stdout: bytes) -> dict:
    """The probe's last stdout line, a JSON object (``{}`` if there is none)."""
    lines = stdout.decode(errors="replace").strip().splitlines()
    try:
        out = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        return {}
    return out if isinstance(out, dict) else {}


def subprocess_trial(config_path: Path, steps: int = 3, timeout: int = 900,
                     device: str = "cuda") -> Callable[[int], bool]:
    """Trial runner executing ``probe_batch`` in a fresh process on
    ``device``. The returned function keeps one record per trial in its
    ``history`` list: batch size, exit code, seconds, and what the probe
    reported (peak memory of a fit, the error text of an OOM)."""

    def trial(bs: int) -> bool:
        cmd = [sys.executable, "-m", "scal_sdt_tpu_torch.cli.probe_batch",
               "--config", str(config_path), "--batch-size", str(bs),
               "--steps", str(steps), "--device", str(device)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            logger.warning(f"Batch-size probe at {bs} timed out; treating as failure")
            trial.history.append({"batch_size": bs, "returncode": None,
                                  "seconds": time.perf_counter() - t0, "timed_out": True})
            return False
        record = {"batch_size": bs, "returncode": proc.returncode,
                  "seconds": time.perf_counter() - t0, **_probe_report(proc.stdout)}
        trial.history.append(record)
        if proc.returncode == PROBE_OK:
            logger.info(f"Batch size {bs}: fits ({record['seconds']:.1f} s, peak "
                        f"{record.get('peak_mem_gib', float('nan')):.2f} GiB)")
            return True
        if proc.returncode == PROBE_OOM:
            logger.info(f"Batch size {bs}: out of memory ({record.get('error', '')[:200]})")
            return False
        tail = proc.stderr.decode(errors="replace")[-2000:]
        raise RuntimeError(
            f"Batch-size probe at {bs} failed for a non-OOM reason "
            f"(rc={proc.returncode}):\n{tail}")

    trial.history = []
    return trial


def tune_batch_size(config, config_path: Path, device: str = "cuda") -> int:
    """Resolve ``trainer.auto_scale_batch_size`` into a concrete batch size
    and return it (``true`` means ``power``; the caller skips it on resume)."""
    setting = config.trainer.get("auto_scale_batch_size", False)
    if not setting:
        return int(config.batch_size)
    mode = setting if isinstance(setting, str) else "power"
    best = search_batch_size(
        subprocess_trial(Path(config_path), device=device),
        init_bs=int(config.batch_size), mode=mode)
    if best <= 0:
        raise RuntimeError(
            f"Auto batch-size tuning: even batch_size={config.batch_size} "
            f"does not fit in device memory")
    logger.info(f"Auto batch-size tuning selected batch_size={best}")
    return best
