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
the snapshot and samples. Not ported yet: ``trainer.auto_scale_batch_size``
(the batch-size tuner, ROADMAP 1.18).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional

import click

import torch.distributed as dist

from .. import conf
from ..device import resolve_device
from ..parallel.mesh import LaunchEnv, init_process_group, process_device
from ..utils.logging import is_main_process
from ..training.sample_callback import SampleCallback
from ..training.trainer import Trainer

logger = logging.getLogger("train")


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
    init_process_group(dev, backend, env)
    if config_path is not None:
        config = conf.load_with_defaults(config_path)
    elif resume_ckpt_path is not None:
        config = get_resuming_config(resume_ckpt_path)
    else:
        raise click.UsageError("Either --config or --resume must be specified")

    if run_id is None:
        run_id = generate_run_id()
        if env.world > 1:   # rank 0's clock names the run
            box = [run_id]
            dist.broadcast_object_list(box, src=0)
            run_id = box[0]
    run_dir = Path(config.output_dir, config.project, run_id)
    run_dir.mkdir(parents=True, exist_ok=True)

    verify_config(config)
    logger.info(f"Run ID: {run_id}")

    if (resume_ckpt_path is None and config_path is not None
            and config.trainer.get("auto_scale_batch_size", False)):
        raise NotImplementedError("trainer.auto_scale_batch_size: the batch-size tuner is "
                                  "not ported yet (ROADMAP 1.18); set batch_size")

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
