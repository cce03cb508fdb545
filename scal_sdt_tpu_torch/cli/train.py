"""Training CLI (port of ``scal_sdt_tpu/cli/train.py``).

``python -m scal_sdt_tpu_torch.cli.train --config cfg.yaml [--run-id ID]
[--resume ckpt.safetensors] [--device cuda] [--backend nccl|gloo]``, or on N
cards of a host ``python -m torch.distributed.run --nproc_per_node N -m
scal_sdt_tpu_torch.cli.train --config cfg.yaml`` (each process on
``cuda:LOCAL_RANK``, the mesh of ``trainer.mesh``; ``batch_size`` is the
host's batch).

The JAX CLI's run-dir layout and resume semantics: checkpoints land in
``<output_dir>/<project>/<run_id>/``, the resolved config is snapshotted to
``config.yaml`` there, and ``--resume`` reloads the snapshot next to the
checkpoint. The run trains on a card unless ``--device cpu`` asks for the
CPU. The run samples ``sampling.concepts`` into ``<run_dir>/samples/<step>/``
every ``sampling.interval_steps`` steps. Rank 0 picks the run id, writes
the snapshot and samples. ``trainer.auto_scale_batch_size`` (``power``,
``binsearch`` or ``true``) picks ``batch_size`` before the run by trials in
subprocesses (``training/tuner.py``), as in JAX only for a ``--config`` run
that does not resume. As JAX tunes on one host's whole mesh, a world of N
ranks on one host runs one search: rank 0 runs the trials, each a world of
N probe ranks on the run's ``trainer.mesh`` (the picked batch is the
host's), and every rank takes the pick before it builds its Trainer. Until
then the ranks share values through torchrun's rendezvous store, holding
no CUDA context or communicator while the trials use the cards. On more
than one host the tuner is skipped with JAX's warning.
"""

from __future__ import annotations

import logging
import time
from datetime import timedelta
from pathlib import Path
from typing import Optional

import click

import torch.distributed as dist

from .. import conf
from ..device import resolve_device
from ..parallel.mesh import (LaunchEnv, init_process_group, process_device, rendezvous_store,
                             share_from_rank0)
from ..utils.logging import is_main_process
from ..training.sample_callback import SampleCallback
from ..training.trainer import Trainer

logger = logging.getLogger("train")

# how long the other ranks wait for rank 0's batch-size search
TUNE_WAIT = timedelta(hours=24)


def generate_run_id() -> str:
    return time.strftime("%y%m%d-%H%M%S")


def get_resuming_config(ckpt_path: Path):
    config_yaml = ckpt_path.parent / "config.yaml"
    if not config_yaml.is_file():
        raise FileNotFoundError("Config not found for the checkpoint specified")
    return conf.load(config_yaml)


def verify_config(config) -> None:
    """Fail-fast validation (the reference's train.py checks)."""
    concepts = config.data.concepts
    have_concepts = bool(concepts)

    if have_concepts and config.data.get("cache") is not None:
        logger.warning("Concepts are set but unused since a cache is specified")
    elif not have_concepts and config.data.get("cache") is None:
        raise ValueError("No concept found and cache file is not specified")

    if not config.prior_preservation.get("enabled", False):
        if any(c.get("class_set") is not None for c in concepts):
            logger.warning("Prior preservation disabled but a concept has a class set")
    elif not all(c.get("class_set") is not None for c in concepts):
        raise ValueError("Prior preservation enabled but not all concepts have class sets")


@click.command()
@click.option("--config", "config_path",
              type=click.Path(exists=True, dir_okay=False, path_type=Path),
              default=None, help="Path to the training config file.")
@click.option("--run-id", type=str, default=None,
              help="Run id for the checkpoint directory (default: timestamp).")
@click.option("--resume", "resume_ckpt_path",
              type=click.Path(exists=True, dir_okay=False, path_type=Path),
              default=None,
              help="Resume from this checkpoint; its run config.yaml is reloaded.")
@click.option("--device", default="cuda", show_default=True,
              help="Device to train on ('cpu' runs without a card; 'cuda' is "
                   "cuda:LOCAL_RANK under torch.distributed.run).")
@click.option("--backend", default=None,
              help="torch.distributed backend over the device's default (nccl on cards, "
                   "gloo on the CPU).")
def main(config_path: Optional[Path], run_id: Optional[str],
         resume_ckpt_path: Optional[Path], device: str, backend: Optional[str]):
    env = LaunchEnv.from_environ()
    dev = resolve_device(process_device(device, env))
    # torchrun's store, no process group yet: nothing on the card until the
    # tuner's trials are done
    store = rendezvous_store(env)
    if config_path is not None:
        config = conf.load_with_defaults(config_path)
    elif resume_ckpt_path is not None:
        config = get_resuming_config(resume_ckpt_path)
    else:
        raise click.UsageError("Either --config or --resume must be specified")

    if run_id is None:   # rank 0's clock names the run
        run_id = share_from_rank0(store, env, "run_id", generate_run_id)
    run_dir = Path(config.output_dir, config.project, run_id)
    run_dir.mkdir(parents=True, exist_ok=True)

    verify_config(config)
    logger.info(f"Run ID: {run_id}")

    # Auto batch-size tuning (reference trainer.tune(): skipped when
    # resuming). Each trial is a subprocess (a world of the host's ranks)
    # with its own CUDA contexts.
    if (resume_ckpt_path is None and config_path is not None
            and config.trainer.get("auto_scale_batch_size", False)):
        if env.hosts > 1:
            # Probe subprocesses cannot join the multi-host slice, and
            # per-host searches could pick different batch sizes and deadlock
            # the collectives (JAX's words, its processes being hosts)
            logger.warning(
                "auto_scale_batch_size is single-host only; skipping on a "
                f"{env.hosts}-process slice (set batch_size "
                "explicitly for multi-host runs)")
        else:
            from ..training.tuner import tune_batch_size

            config.batch_size = share_from_rank0(
                store, env, "batch_size",
                lambda: tune_batch_size(config, config_path, device=device, nproc=env.world,
                                        backend=backend), wait=TUNE_WAIT)

    init_process_group(dev, backend, env, store)
    trainer = Trainer(config, run_dir, device=dev, backend=backend)
    if resume_ckpt_path is not None:
        trainer.resume(resume_ckpt_path)

    if is_main_process():
        conf.save(config, run_dir / "config.yaml")
    trainer.fit(sample_callback=SampleCallback(run_dir / "samples"))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main()
