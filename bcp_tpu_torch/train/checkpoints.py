"""Checkpoints of the port: reference-layout ``.pth`` files.

The reference saves the student's state_dict (`LA_BCP_train.py:79-93,
176-189,287`); the port's modules carry the reference names, so a file
written here loads strictly into the eval model of slice 1 and into the
reference's own V-Net. Per stage directory: ``iter_{i}_dice_{d}.pth`` at a
new best validation, ``{model}_best_model.pth`` (the stage hand-off,
`checkpoints.py:102-114`) and ``last.pth``. The JAX package's orbax state
(optimizer, teacher, step: its ``--resume``) is not ported yet.
"""

from __future__ import annotations

import os
import shutil
from typing import Sequence

import torch
from torch import nn

from bcp_tpu_torch.config import Config


def snapshot_dir(cfg: Config, stage_name: str) -> str:
    """``<snapshot_root>/<name>_<exp>_<labelnum>_labeled/<stage_name>``."""
    run = f"{cfg.name}_{cfg.exp}_{cfg.labelnum}_labeled"
    return os.path.join(cfg.snapshot_root, run, stage_name)


def best_model_path(snapshot: str, model_name: str) -> str:
    """The reference's ``{model}_best_model.pth`` in a stage directory."""
    return os.path.join(snapshot, f"{model_name}_best_model.pth")


def save_model(path: str, model: nn.Module) -> None:
    """The module's state_dict on the host, written whole or not at all."""
    host = {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
    tmp = f"{path}.tmp"
    torch.save(host, tmp)
    os.replace(tmp, path)


def save_many(paths: Sequence[str], model: nn.Module) -> None:
    """One device-to-host fetch and one serialisation for several names
    (the tagged, best and last files of a validation)."""
    save_model(paths[0], model)
    for path in paths[1:]:
        tmp = f"{path}.tmp"
        shutil.copyfile(paths[0], tmp)
        os.replace(tmp, path)
