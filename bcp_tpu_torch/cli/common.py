"""Shared CLI helpers: ``bcp_tpu/cli/common.py`` for the port."""

from __future__ import annotations

import os
from typing import Optional

import torch

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.convert import load_reference_checkpoint
from bcp_tpu_torch.models import create_model

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def snapshot_dir(cfg: Config, stage_name: str) -> str:
    run = f"{cfg.name}_{cfg.exp}_{cfg.labelnum}_labeled"
    return os.path.join(cfg.snapshot_root, run, stage_name)


def best_model_path(snapshot: str, model_name: str) -> str:
    """The reference's ``{model}_best_model.pth`` in a stage directory."""
    return os.path.join(snapshot, f"{model_name}_best_model.pth")


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
    extra = {"n_filters": cfg.n_filters} if cfg.n_filters else {}
    model = create_model(cfg.net_type, cfg.num_classes,
                         compute_dtype=_DTYPES[cfg.compute_dtype],
                         device=device, **extra)
    model.load_state_dict(load_reference_checkpoint(path), strict=True)
    return model
