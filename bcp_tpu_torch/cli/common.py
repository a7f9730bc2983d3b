"""Shared CLI helpers: ``bcp_tpu/cli/common.py`` for the port.

``--num_devices N`` (every CLI) runs the CLI's core on N ranks: the CLI
spawns them itself (:func:`on_ranks`, ``parallel.mesh.launch``), one
process a card (``cuda:0`` .. ``cuda:N-1`` over NCCL) or, with ``--device
cpu``, N processes over gloo. ``-1`` is every visible card; asking for
more cards than are visible raises, nothing runs on fewer. The train
CLIs' ``--sp_devices S`` splits each volume's x extent over S of them
(``parallel.mesh``): N/S data indices by S space indices; S must divide N.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.convert import load_checkpoint, load_reference_checkpoint
from bcp_tpu_torch.data.preprocess import write_nifti
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train.state import build_model
from bcp_tpu_torch.utils.worker import OrderedWorker


def ranks(args) -> int:
    """The ranks of ``--num_devices`` on ``--device``; a train CLI's
    ``--sp_devices`` must divide them (JAX `mesh.py:59-61`)."""
    try:
        n = mesh.resolve_count(args.num_devices, args.device)
    except ValueError as e:
        raise SystemExit(f"error: --num_devices: {e} (ROADMAP A4, "
                         f"multi-GPU)") from e
    sp = getattr(args, "sp_devices", 1)
    if sp < 1 or n % sp:
        raise SystemExit(f"error: --sp_devices: sp_devices={sp} must divide "
                         f"the mesh size {n} (--num_devices)")
    return n


def run_stages(trainer, args):
    """Run the stages of ``--stage``: {stage: (best dice, best .pth)}."""
    if mesh.is_main():
        print("Starting BCP training.")
    out = {}
    if args.stage in ("both", "pre"):
        out["pre"] = trainer.pretrain(resume=args.resume)
    if args.stage in ("both", "self"):
        out["self"] = trainer.selftrain(resume=args.resume)
    return out


def train_on_ranks(module: str, args, train_dataset, val_cases, on_step,
                   overrides):
    """A train CLI's ``train``: ``module``'s ``build_trainer``, then
    :func:`run_stages`; returns (trainer, {stage: (best dice, best .pth)}).
    With ``--num_devices N > 1`` the stages run on N spawned ranks and the
    trainer, which lives in them, is None (the datasets must pickle;
    ``on_step``, a hook of this process, is refused)."""
    import importlib
    mod = importlib.import_module(module)
    n = ranks(args)
    if n > 1 and not mesh.active():
        if on_step is not None:
            raise ValueError("on_step is called in this process; the ranks "
                             "of --num_devices > 1 are other processes")
        return None, on_ranks(_train_rank, n, args.device, module, args,
                              train_dataset, val_cases, overrides)
    trainer = mod.build_trainer(args, train_dataset, val_cases, on_step,
                                **overrides)
    return trainer, run_stages(trainer, args)


def _train_rank(module, args, train_dataset, val_cases, overrides):
    import importlib
    mod = importlib.import_module(module)
    return run_stages(mod.build_trainer(args, train_dataset, val_cases,
                                        **overrides), args)


def on_ranks(fn: Callable, n: int, device, *args):
    """``fn(*args)`` in this process when ``n`` is 1 or it already is a
    rank of a world; else on ``n`` spawned ranks (its arguments and result
    must pickle), returning rank 0's result."""
    if n == 1 or mesh.active():
        return fn(*args)
    return mesh.launch(fn, n, device, *args)


def load_eval_model(cfg: Config, ckpt_path: str,
                    torch_ckpt: Optional[str] = None, device=None):
    """The eval-mode model of ``cfg`` on ``device``, its weights from the
    reference-layout ``.pth`` ``torch_ckpt`` (a zoo net with no known
    reference layout raises the JAX converter's ``KeyError``), else the
    port's own checkpoint ``ckpt_path``. The JAX package's orbax snapshots
    need JAX to read: ``bcp_tpu/cli/export_torch.py`` turns one into a
    ``.pth``."""
    path = torch_ckpt or ckpt_path
    if not os.path.exists(path):
        raise SystemExit(
            f"error: no checkpoint at {path}: pass --torch_ckpt with a "
            f"reference-layout .pth (orbax snapshots of the JAX package are "
            f"not readable by the port yet)")
    model = build_model(cfg, "test", device)
    load = load_reference_checkpoint if torch_ckpt else load_checkpoint
    model.load_state_dict(load(path, cfg.net_type), strict=True)
    return model


class ResultWriter:
    """``--save_result``'s NIfTI dumps (float32, ``data.preprocess.
    write_nifti``), written in order on one background thread
    (``utils.worker.OrderedWorker``), so gzip runs while the card
    evaluates the next volume. ``write`` copies the volumes first; at most
    two cases wait or run at a time; ``close`` returns once every file is
    complete and re-raises a write's error. Off (``enabled`` false), and
    on a rank other than 0, it writes nothing."""

    def __init__(self, enabled: bool):
        # rank 0 alone writes in a world of several ranks
        self._worker = (OrderedWorker(2) if enabled and mesh.is_main()
                        else None)

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
