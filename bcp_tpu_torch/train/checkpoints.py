"""Checkpoints of the port: reference-layout ``.pth`` files.

The reference saves the student's state_dict (`LA_BCP_train.py:79-93,
176-189,287`); the port's modules carry the reference names, so a file
written here loads strictly into the eval model of slice 1 and into the
reference's own V-Net. Per stage directory: ``iter_{i}_dice_{d}.pth`` at a
new best validation, ``{model}_best_model.pth`` (the stage hand-off,
`checkpoints.py:102-130`) and ``last.pth``. Where the next stage takes the
optimizer too (``Config.load_opt_state``, ACDC) these files hold the
reference's ``save_net_opt`` layout, ``{'net': state_dict, 'opt':
optimizer state}`` (`ACDC_BCP_train.py:60-74`), which
``convert.load_checkpoint`` unwraps to the state_dict.

Beside them, ``last_state.pt`` holds the stage's full train state at its
last validation (student, teacher, optimizer with its momentum buffers,
step): what ``--resume`` restores, the counterpart of the JAX package's
orbax ``last`` and ``CheckpointIO.restore`` (`checkpoints.py:96-100`).
States are saved from a :func:`snapshot`, a copy that the training loop
cannot change any more, so a background worker can write them. In a world
of several ranks (``parallel.mesh``) every rank holds the same state and
rank 0 alone writes it (:func:`save_many`); the trainer's barrier at the
end of a stage makes the others wait for its files.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Sequence

import torch

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train.state import load_optimizer

STATE_FILE = "last_state.pt"


def snapshot_dir(cfg: Config, stage_name: str) -> str:
    """``<snapshot_root>/<name>_<exp>_<labelnum>_labeled/<stage_name>``."""
    run = f"{cfg.name}_{cfg.exp}_{cfg.labelnum}_labeled"
    return os.path.join(cfg.snapshot_root, run, stage_name)


def best_model_path(snapshot: str, model_name: str) -> str:
    """The reference's ``{model}_best_model.pth`` in a stage directory."""
    return os.path.join(snapshot, f"{model_name}_best_model.pth")


def _map(fn, tree: Any) -> Any:
    """``fn`` over every tensor of a state_dict-like tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree.detach())
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def snapshot(state) -> Dict[str, Any]:
    """A copy of the whole train state on its device, made on the calling
    thread's stream: the next step updates the student, the teacher and
    the momentum buffers in place, and a validation or checkpoint job must
    not see that (the JAX loop copies for the same reason: its step
    donates the buffers, `trainer.py:386-391`)."""
    return _map(torch.clone, {"model": state.model.state_dict(),
                              "teacher": state.teacher.state_dict(),
                              "optimizer": state.optimizer.state_dict(),
                              "step": int(state.step)})


def _write(obj: Any, path: str) -> None:
    """Written whole or not at all."""
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_many(paths: Sequence[str], snap: Dict[str, Any],
              with_opt: bool = False) -> None:
    """The student's state_dict of a :func:`snapshot` under several names
    (the tagged, best and last files of a validation: one device-to-host
    fetch and one serialisation), with ``with_opt`` beside the optimizer's
    state as ``{'net', 'opt'}``; and the full state beside the last of
    them as ``last_state.pt``. Only rank 0 of a world writes."""
    if not mesh.is_main():
        return
    host = _map(lambda t: t.to("cpu"), snap)
    _write({"net": host["model"], "opt": host["optimizer"]} if with_opt
           else host["model"], paths[0])
    for path in paths[1:]:
        tmp = f"{path}.tmp"
        shutil.copyfile(paths[0], tmp)
        os.replace(tmp, path)
    _write(host, os.path.join(os.path.dirname(paths[-1]), STATE_FILE))


def load_optimizer_state(path: str) -> Dict[str, Any]:
    """The optimizer state of a ``{'net', 'opt'}`` checkpoint (what the
    ACDC self-train stage starts from, `checkpoints.py:116-130`)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(blob, dict) and isinstance(blob.get("opt"), dict)):
        raise ValueError(f"{path} holds no optimizer state ('opt'): it was "
                         f"not written with the optimizer")
    return blob["opt"]


def restore_state(path: str, state):
    """Full resume (`CheckpointIO.restore`, `checkpoints.py:96-100`): the
    student, the teacher, the optimizer with its momentum buffers and the
    step of a ``last_state.pt``, loaded in place into ``state``."""
    saved = torch.load(path, map_location="cpu")
    state.model.load_state_dict(saved["model"], strict=True)
    state.teacher.load_state_dict(saved["teacher"], strict=True)
    load_optimizer(state.optimizer, saved["optimizer"])
    state.step = int(saved["step"])
    return state


def scan_best_dice(snapshot_dir: str) -> float:
    """Best validation dice already achieved in a stage directory, parsed
    from the ``iter_{i}_dice_{d}[.pth]`` snapshot names
    (`checkpoints.py:136-155`). Used when resuming, so that a restarted
    stage cannot save ``{model}_best_model.pth`` over a better historical
    checkpoint."""
    best = 0.0
    if not os.path.isdir(snapshot_dir):
        return best
    for name in os.listdir(snapshot_dir):
        if not name.startswith("iter_") or "_dice_" not in name:
            continue
        value = name.rsplit("_dice_", 1)[1]
        if value.endswith(".pth"):
            value = value[:-len(".pth")]
        try:
            best = max(best, float(value))
        except ValueError:
            continue
    return best
