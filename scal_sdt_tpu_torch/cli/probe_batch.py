"""One batch-size trial for the auto batch-size tuner (port of
``scal_sdt_tpu/cli/probe_batch.py``).

``python -m scal_sdt_tpu_torch.cli.probe_batch --config cfg.yaml
--batch-size N [--steps 3] [--device cuda]`` trains a few real steps at
``--batch-size`` in THIS process and exits: 0 = fits, 3 = the device ran out
of memory, anything else = a real error, re-raised. ``training.tuner`` runs
it as a subprocess, so every trial starts from a fresh CUDA context. Its
last stdout line is a JSON report: the batch size, and the steps taken and
peak device memory of a fit or the error text of an OOM.
"""

from __future__ import annotations

import json
import logging
import sys
import tempfile
from pathlib import Path

import click
import torch

from .. import conf
from ..device import resolve_device

logger = logging.getLogger("probe_batch")

# the JAX package's markers (its runtime's words); torch's allocator says
# "CUDA out of memory", cuBLAS and cuDNN name their failed allocations
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
               "Allocation failure", "OOM", "CUBLAS_STATUS_ALLOC_FAILED",
               "CUDNN_STATUS_ALLOC_FAILED")


@click.command()
@click.option("--config", "config_path", required=True,
              type=click.Path(exists=True, dir_okay=False, path_type=Path))
@click.option("--batch-size", type=int, required=True)
@click.option("--steps", type=int, default=3)
@click.option("--device", default="cuda", show_default=True,
              help="Device of the trial ('cpu' runs without a card).")
def main(config_path: Path, batch_size: int, steps: int, device: str):
    dev = resolve_device(device)
    config = conf.load_with_defaults(config_path)
    config.batch_size = batch_size
    # keep the trial hermetic: no loggers, no checkpoints, no sampling
    config.loggers = {}
    config.checkpoint = {}
    config.sampling = None

    from ..training.trainer import Trainer

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        with tempfile.TemporaryDirectory() as run_dir:
            trainer = Trainer(config, Path(run_dir), device=dev)
            # final_save=False: a probe must not pay a multi-GB checkpoint
            # write per trial, and a failing save would surface as a non-OOM
            # error that aborts the whole tuning run
            trainer.fit(max_steps_override=steps, final_save=False)
    except Exception as e:  # noqa: BLE001 - the exit code IS the result
        msg = f"{type(e).__name__}: {e}"
        if any(m in msg for m in OOM_MARKERS):
            logger.info(f"batch_size={batch_size}: OOM")
            print(json.dumps({"batch_size": batch_size, "fits": False, "error": msg[:2000]}),
                  flush=True)
            sys.exit(3)
        logger.error(msg)
        raise
    report = {"batch_size": batch_size, "fits": True, "steps": int(trainer.global_step)}
    if dev.type == "cuda":
        report["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    logger.info(f"batch_size={batch_size}: ok")
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main()
