"""Logging and the TensorBoard writer: ``bcp_tpu/utils/logging.py`` for the
port. A per-stage ``log.txt`` plus stdout logger (`LA_BCP_train.py:363-370`)
and tensorboardX scalars under the reference's tags; without tensorboardX
the writer does nothing."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

try:
    from tensorboardX import SummaryWriter
except ImportError:  # pragma: no cover
    SummaryWriter = None


def setup_logging(log_dir: str, name: str = "bcp_tpu_torch"
                  ) -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(f"{name}:{log_dir}")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)
    fmt = logging.Formatter(
        "[%(asctime)s.%(msecs)03d] %(message)s", datefmt="%H:%M:%S")
    fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    logger.propagate = False
    return logger


class MetricWriter:
    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if log_dir is not None and SummaryWriter is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._writer = SummaryWriter(log_dir)

    def scalar(self, tag: str, value, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
