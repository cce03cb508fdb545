"""One batch-size trial for the auto batch-size tuner (port of
``scal_sdt_tpu/cli/probe_batch.py``).

``python -m scal_sdt_tpu_torch.cli.probe_batch --config cfg.yaml
--batch-size N [--steps 3] [--device cuda] [--backend gloo] [--report-dir
DIR]`` trains a few real steps at ``--batch-size`` in THIS process and
exits: 0 = fits, 3 = the device ran out of memory, anything else = a real
error, re-raised. ``training.tuner`` runs it as a subprocess, so every trial
starts from a fresh CUDA context. Its last stdout line is a JSON report: the
batch size, and the steps taken and peak device memory of a fit or the
error text of an OOM (``oom``: whether it was one). Under
``torch.distributed.run`` every rank is one probe of a world on the
config's ``trainer.mesh`` (``--batch-size`` is the host's) and also writes
its report to ``DIR/rank<RANK>.json``; a rank that fails ends its process at
once (``os._exit``), so a peer blocked in a collective does not keep the
world alive: torchrun then stops the rest.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
import traceback
from pathlib import Path
from typing import Optional

import click
import torch

import torch.distributed as dist

from .. import conf
from ..device import resolve_device
from ..parallel.mesh import LaunchEnv, process_device

logger = logging.getLogger("probe_batch")

# the JAX package's markers (its runtime's words); torch's allocator says
# "CUDA out of memory", cuBLAS and cuDNN name their failed allocations
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
               "Allocation failure", "OOM", "CUBLAS_STATUS_ALLOC_FAILED",
               "CUDNN_STATUS_ALLOC_FAILED")


def _report(report: dict, report_dir: Optional[Path], rank: int, stdout: bool = True) -> None:
    """The JSON report on stdout and, with ``report_dir``, in its rank's file
    (written whole, then renamed)."""
    if stdout:
        print(json.dumps(report), flush=True)
    if report_dir is not None:
        path = Path(report_dir) / f"rank{rank}.json"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(report))
        os.replace(tmp, path)


@click.command()
@click.option("--config", "config_path", required=True,
              type=click.Path(exists=True, dir_okay=False, path_type=Path))
@click.option("--batch-size", type=int, required=True)
@click.option("--steps", type=int, default=3)
@click.option("--device", default="cuda", show_default=True,
              help="Device of the trial ('cpu' runs without a card; 'cuda' is "
                   "cuda:LOCAL_RANK under torch.distributed.run).")
@click.option("--backend", default=None,
              help="torch.distributed backend of a world's probes over the device's default.")
@click.option("--report-dir", type=click.Path(file_okay=False, path_type=Path), default=None,
              help="Directory for this rank's report file (rank<RANK>.json).")
def main(config_path: Path, batch_size: int, steps: int, device: str, backend: Optional[str],
         report_dir: Optional[Path]):
    env = LaunchEnv.from_environ()
    dev = resolve_device(process_device(device, env))
    config = conf.load_with_defaults(config_path)
    config.batch_size = batch_size
    # keep the trial hermetic: no loggers, no checkpoints, no sampling
    config.loggers = {}
    config.checkpoint = {}
    config.sampling = None

    from ..training.trainer import Trainer

    if dev.type == "cuda":
        torch.cuda.set_device(dev)   # CUDA's first use in this process: an explicit index
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        with tempfile.TemporaryDirectory() as run_dir:
            trainer = Trainer(config, Path(run_dir), device=dev, backend=backend)
            # final_save=False: a probe must not pay a multi-GB checkpoint
            # write per trial, and a failing save would surface as a non-OOM
            # error that aborts the whole tuning run
            trainer.fit(max_steps_override=steps, final_save=False)
    except Exception as e:  # noqa: BLE001 - the exit code IS the result
        msg = f"{type(e).__name__}: {e}"
        oom = any(m in msg for m in OOM_MARKERS)
        # a real error re-raises: its report goes to the trial's file only
        _report({"batch_size": batch_size, "fits": False, "oom": oom, "error": msg[:2000]},
                report_dir, env.rank, stdout=oom)
        if oom:
            logger.info(f"batch_size={batch_size}: OOM")
        else:
            logger.error(msg)
        if env.world > 1:
            # end this rank now: its peers may be blocked in a collective
            if not oom:
                traceback.print_exc()
            sys.stderr.flush()
            os._exit(3 if oom else 1)
        if oom:
            sys.exit(3)
        raise
    report = {"batch_size": batch_size, "fits": True, "steps": int(trainer.global_step)}
    if dev.type == "cuda":
        report["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    logger.info(f"batch_size={batch_size}: ok")
    _report(report, report_dir, env.rank)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main()
