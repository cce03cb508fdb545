"""The port's batch-size probe with a capacity, for tests/test_torch_tuner_world.py.

``python -m torch_probe_capacity <probe_batch arguments>`` (``tests`` on
``PYTHONPATH``) runs ``scal_sdt_tpu_torch.cli.probe_batch`` unchanged, except
that on rank ``PROBE_OOM_RANK`` (default 1) a batch above ``PROBE_CAPACITY``
raises the card's out-of-memory error as the Trainer starts to fit, while
the other ranks go on into their first collective: the CPU's stand-in for
one rank of a world running out of memory.
"""

import os

import torch

from scal_sdt_tpu_torch.cli import probe_batch
from scal_sdt_tpu_torch.training.trainer import Trainer

_real_fit = Trainer.fit


def _fit(self, *args, **kwargs):
    if (int(self.config.batch_size) > int(os.environ["PROBE_CAPACITY"])
            and os.environ.get("RANK", "0") == os.environ.get("PROBE_OOM_RANK", "1")):
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of "
            "79.19 GiB of which 1.12 GiB is free.")
    return _real_fit(self, *args, **kwargs)


Trainer.fit = _fit

if __name__ == "__main__":
    probe_batch.main()
