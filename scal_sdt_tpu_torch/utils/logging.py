"""Process-zero-gated logging (port of ``scal_sdt_tpu/utils/logging.py``).

Under a multi-process launch every rank runs the same program; only rank 0
should emit console logs, write samples, or push metrics. The rank comes
from the ``RANK`` environment variable that ``torchrun`` sets (0 when it is
absent: a single process).
"""

from __future__ import annotations

import logging
import os


def process_rank() -> int:
    return int(os.environ.get("RANK", "0"))


def is_main_process() -> bool:
    return process_rank() == 0


class _MainProcessFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        return is_main_process()


def main_process_logger(name: str = "scal-sdt-tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not any(isinstance(f, _MainProcessFilter) for f in logger.filters):
        logger.addFilter(_MainProcessFilter())
    return logger
