"""Shared CLI helpers: ``bcp_tpu/cli/common.py`` for the port."""

from __future__ import annotations

import os
from functools import partial
from typing import Optional, Sequence

import numpy as np

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.convert import load_reference_checkpoint
from bcp_tpu_torch.data.preprocess import write_nifti
from bcp_tpu_torch.train.state import build_model
from bcp_tpu_torch.utils.worker import OrderedWorker


def load_eval_model(cfg: Config, ckpt_path: str,
                    torch_ckpt: Optional[str] = None, device=None):
    """The eval-mode model of ``cfg`` on ``device``, its weights from the
    reference-layout ``.pth`` ``torch_ckpt``, else ``ckpt_path``. The JAX
    package's orbax snapshots need JAX to read and wait for the trainer
    slice."""
    path = torch_ckpt or ckpt_path
    if not os.path.exists(path):
        raise SystemExit(
            f"error: no checkpoint at {path}: pass --torch_ckpt with a "
            f"reference-layout .pth (orbax snapshots of the JAX package are "
            f"not readable by the port yet)")
    model = build_model(cfg, "test", device)
    model.load_state_dict(load_reference_checkpoint(path, cfg.net_type),
                          strict=True)
    return model


class ResultWriter:
    """``--save_result``'s NIfTI dumps (float32, ``data.preprocess.
    write_nifti``), written in order on one background thread
    (``utils.worker.OrderedWorker``), so gzip runs while the card
    evaluates the next volume. ``write`` copies the volumes first; at most
    two cases wait or run at a time; ``close`` returns once every file is
    complete and re-raises a write's error. Off (``enabled`` false) it
    writes nothing."""

    def __init__(self, enabled: bool):
        self._worker = OrderedWorker(2) if enabled else None

    def write(self, paths: Sequence[str], volumes,
              spacing=(1.0, 1.0, 1.0)) -> None:
        if self._worker is None:
            return
        vols = [np.asarray(v).astype(np.float32) for v in volumes]
        self._worker.submit(partial(_write_all, list(paths), vols, spacing))

    def close(self) -> None:
        if self._worker is None:
            return
        worker, self._worker = self._worker, None
        try:
            worker.drain()
        finally:
            worker.close()


def _write_all(paths, vols, spacing) -> None:
    for path, vol in zip(paths, vols):
        write_nifti(path, vol, spacing=spacing)


def case_name(dataset, i: int) -> str:
    """The name of case ``i``: the dataset's own (``ACDCDataset.cases``),
    else its index, ``"%02d"``."""
    cases = getattr(dataset, "cases", None)
    return cases[i] if cases and isinstance(cases[i], str) else "%02d" % i
