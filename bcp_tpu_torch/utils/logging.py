"""Logging and the TensorBoard writer: ``bcp_tpu/utils/logging.py`` for the
port. A per-stage ``log.txt`` plus stdout logger (`LA_BCP_train.py:363-370`)
and tensorboardX scalars and images under the reference's tags; without
tensorboardX the writer does nothing. The pancreas pipeline logs through
per-epoch meters (:class:`Measures`, `logging.py:85-146`)."""

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


def null_logger(name: str = "bcp_tpu_torch:quiet") -> logging.Logger:
    """A logger that writes nothing: a rank other than 0's."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
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

    def image(self, tag: str, img, step: int):
        if self._writer is not None:
            self._writer.add_image(tag, img, step)

    def images(self, tag: str, imgs, step=None):
        """A batch of images, ``add_images`` (`LA_BCP_train.py:321,340`
        passes no global step)."""
        if self._writer is not None:
            self._writer.add_images(tag, imgs, step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()


class AverageMeter:
    """`pancreas/pancreas_utils.py:90-108`."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0
        return self

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val
        self.count += n
        self.avg = self.sum / self.count
        return self


class Measures:
    """A keyed group of :class:`AverageMeter` logged every step: the latest
    values to the logger as ``Epoch : e, k: v, ...``, the averages to the
    writer as ``{prefix}/{k}`` (`pancreas_utils.py:111-150,223-251`)."""

    def __init__(self, keys, writer: MetricWriter, logger,
                 prefix: str = "pretrain"):
        self.keys = list(keys)
        self.measures = {k: AverageMeter() for k in self.keys}
        self.writer = writer
        self.logger = logger
        self.prefix = prefix

    def reset(self):
        for m in self.measures.values():
            m.reset()

    def update(self, **values):
        for k, v in values.items():
            self.measures[k].update(float(v))

    def log(self, epoch: int, step: int):
        if self.logger is not None:
            self.logger.info("Epoch : %d, %s", epoch, ", ".join(
                f"{k}: {self.measures[k].val:.4f}" for k in self.keys))
        for k, m in self.measures.items():
            self.writer.scalar(f"{self.prefix}/{k}", m.avg, step)
        self.writer.flush()


def cut_pre_measures(writer, logger) -> Measures:
    """`CutPreMeasures` (`pancreas_utils.py:122-150`)."""
    return Measures(["ce_loss", "dice_loss", "loss_all", "train_dice"],
                    writer, logger)


def cutmix_ft_measures(writer, logger) -> Measures:
    """`CutmixFTMeasures` (`pancreas_utils.py:223-251`); its tags keep the
    reference's ``pretrain/`` prefix."""
    return Measures(["mix_loss_lab", "mix_loss_unlab", "loss_all"],
                    writer, logger)
