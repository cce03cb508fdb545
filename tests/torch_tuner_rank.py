"""One rank of a tuned train CLI run, for tests/test_torch_tuner_world.py.

``python -m torch.distributed.run --standalone --nproc_per_node N
tests/torch_tuner_rank.py OUT.json -- <cli.train arguments>`` runs the
port's train CLI unchanged, with the tuner's trials run by
``torch_probe_capacity`` (``PROBE_CAPACITY`` in the environment), and
writes what this rank saw to ``OUT.rank<RANK>.json``: the batch its Trainer
was built with, the steps it took, its world, and on rank 0 each trial's
record and whether a process group existed while the trials ran.
"""

import json
import os
import sys
from pathlib import Path

import torch.distributed as dist

from scal_sdt_tpu_torch.cli import train as train_cli
from scal_sdt_tpu_torch.training import tuner
from scal_sdt_tpu_torch.training.trainer import Trainer


def main(out: str, cli_args: list[str]) -> None:
    seen: dict = {"trials": [], "group_during_trials": []}
    real_trial, real_fit = tuner.subprocess_trial, Trainer.fit

    def recording_trial(*args, **kwargs):
        run = real_trial(*args, **kwargs)

        def trial(bs):
            seen["group_during_trials"].append(dist.is_initialized())
            return run(bs)
        trial.history = run.history
        seen["trials"] = run.history
        return trial

    def fit(self, *args, **kwargs):
        seen["batch_size"] = int(self.config.batch_size)
        out = real_fit(self, *args, **kwargs)
        seen["global_step"] = int(self.global_step)
        seen["world"] = dist.get_world_size()
        seen["backend"] = dist.get_backend()
        return out

    tuner.PROBE_MODULE = "torch_probe_capacity"
    tuner.subprocess_trial, Trainer.fit = recording_trial, fit
    train_cli.main(cli_args, standalone_mode=False)
    rank = int(os.environ["RANK"])
    Path(f"{out}.rank{rank}.json").write_text(json.dumps(seen))


if __name__ == "__main__":
    sep = sys.argv.index("--")
    main(sys.argv[1], sys.argv[sep + 1:])
