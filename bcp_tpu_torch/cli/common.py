"""Shared CLI helpers: ``bcp_tpu/cli/common.py`` for the port."""

from __future__ import annotations

import os
from typing import Optional

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.convert import load_reference_checkpoint
from bcp_tpu_torch.train.state import build_model


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
