"""The LA two-stage BCP trainer: ``bcp_tpu/train/trainer.py``'s LA path for
the port.

Copy-paste pre-training, then bidirectional copy-paste mean-teacher
self-training from the pre-train stage's best checkpoint, with validation
(mean Dice of the slice-1 sliding-window evaluator over the test split, as
the reference does) every ``eval_every`` steps, best-Dice checkpoints, and
an end-of-stage validation when a stage saved no best model
(`trainer.py:271-590`). Validation runs inline, between steps: the JAX
package's background validation worker gives the same validations,
best-Dice sequence and checkpoints, only sooner. Step losses are read back
one step late, so the host enqueues step i+1 before it waits for step i's
numbers.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.data.datasets import LAHeartDataset
from bcp_tpu_torch.data.feed import BCPBatchFeeder
from bcp_tpu_torch.device import resolve_device
from bcp_tpu_torch.convert import load_reference_checkpoint
from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator
from bcp_tpu_torch.ops.masks import cuboid_mask, cuboid_starts
from bcp_tpu_torch.ops.ramps import sigmoid_rampup
from bcp_tpu_torch.train.checkpoints import (best_model_path, save_many,
                                             save_model, snapshot_dir)
from bcp_tpu_torch.train.state import (TrainState, build_model, init_state,
                                       load_weights_only)
from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
from bcp_tpu_torch.utils.logging import MetricWriter, setup_logging


class BCPTrainer:
    """``train_dataset`` (``len`` + ``sample_train``) and ``val_cases``
    ((image, label) pairs) default to the LA train and test splits under
    ``cfg.root_path``. ``on_step(stage, iteration)``, when given, is called
    after each iteration has enqueued its step and read back the step
    before it, ahead of that iteration's validation; ``chip_smoke.py``
    times and traces the loop's steps with it."""

    def __init__(self, cfg: Config, device=None, train_dataset=None,
                 val_cases: Optional[List[Tuple[np.ndarray, np.ndarray]]]
                 = None,
                 on_step: Optional[Callable[[str, int], None]] = None):
        if cfg.variant != "la":
            raise NotImplementedError("the port's trainer runs LA")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pre_dir = snapshot_dir(cfg, "pre_train")
        self.self_dir = snapshot_dir(cfg, "self_train")
        self.train_dataset = train_dataset
        self._val_cases = val_cases
        self.on_step = on_step
        self.eval_model = build_model(cfg, "test", self.device)
        self.evaluator = SlidingWindowEvaluator(
            self.eval_model, cfg.patch_size, cfg.num_classes, cfg.stride_xy,
            cfg.stride_z, batch=cfg.eval_batch, device=self.device)
        #: validations run, for callers that count kernel launches
        self.validations = 0

    # ---------------- validation ----------------
    def _load_val_cases(self):
        if self._val_cases is None:
            ds = LAHeartDataset(self.cfg.root_path, "test")
            self._val_cases = [ds.load(i) for i in range(len(ds))]
        return self._val_cases

    def validate(self, state: TrainState) -> float:
        """Mean Dice of the student (`var_all_case_LA`)."""
        self.eval_model.load_state_dict(state.model.state_dict())
        self.validations += 1
        return self.evaluator.validate_dice(self._load_val_cases(),
                                            rule=self.cfg.eval_rule)

    # ---------------- stages ----------------
    def _run_stage(self, stage: str, max_iterations: int,
                   init_from: Optional[str] = None) -> Tuple[float, str]:
        cfg = self.cfg
        out_dir = self.pre_dir if stage == "pre" else self.self_dir
        os.makedirs(out_dir, exist_ok=True)
        logger = setup_logging(out_dir)
        writer = MetricWriter(os.path.join(out_dir, "log"))
        logger.info("config: %s", cfg)
        state = init_state(cfg, self.device)
        if init_from is not None:
            # weights-only hand-off (`LA_BCP_train.py:220-222`)
            load_weights_only(state, load_reference_checkpoint(init_from))
            logger.info("loaded from %s", init_from)
        dataset = self.train_dataset
        if dataset is None:
            dataset = LAHeartDataset(cfg.root_path, "train", cache=True)
        feeder = BCPBatchFeeder(cfg, stage, dataset, self.device)
        logger.info("%d iterations per epoch", feeder.steps_per_epoch)
        offset = 0 if stage == "pre" else 1
        mask_rng = np.random.default_rng(cfg.seed + offset)
        dropout_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + offset)
        best = 0.0
        best_path = best_model_path(out_dir, cfg.net_type)
        last_path = os.path.join(out_dir, "last.pth")
        tags = ({"loss_dice": "pre/loss_dice", "loss_ce": "pre/loss_ce",
                 "loss": "pre/loss_all"} if stage == "pre" else
                {"loss_l": "Self/loss_l", "loss_u": "Self/loss_u",
                 "loss": "Self/loss_all"})

        def emit(it: int, metrics: Dict[str, torch.Tensor]) -> None:
            host = {k: float(v) for k, v in metrics.items()}
            if it % cfg.log_every == 0:
                for k, tag in tags.items():
                    writer.scalar(tag, host[k], it)
                logger.info("iteration %d : %s", it, " ".join(
                    f"{k}: {v:.4f}" for k, v in sorted(host.items())))

        def run_validation(it: int) -> None:
            nonlocal best
            tv = time.time()
            dice = self.validate(state)
            if dice > best:
                best = round(dice, 4)
                tagged = os.path.join(out_dir, f"iter_{it}_dice_{best}.pth")
                save_many([tagged, best_path, last_path], state.model)
                logger.info("save best model to %s", tagged)
            else:
                save_model(last_path, state.model)
            writer.scalar("4_Var_dice/Dice", dice, it)
            writer.scalar("4_Var_dice/Best_dice", best, it)
            logger.info("validation@%d: dice %.4f (%.2fs)", it, dice,
                        time.time() - tv)

        t0 = time.time()
        pending = None
        try:
            for it in range(1, max_iterations + 1):
                batch = next(feeder)
                mask = cuboid_mask(cfg.patch_size,
                                   cuboid_starts(mask_rng, cfg.patch_size,
                                                 cfg.mask_ratio),
                                   cfg.mask_ratio, self.device)
                if stage == "pre":
                    metrics = pretrain_step(state, batch, mask, cfg,
                                            dropout_gen)
                else:
                    metrics = selftrain_step(state, batch, mask, cfg,
                                             dropout_gen, dropout_gen)
                    # computed and logged, never applied (reference parity,
                    # `LA_BCP_train.py:246,260`)
                    writer.scalar("Self/consistency", cfg.consistency *
                                  sigmoid_rampup(it // 150,
                                                 cfg.consistency_rampup), it)
                if pending is not None:
                    emit(*pending)
                pending = (it, metrics)
                if self.on_step is not None:
                    self.on_step(stage, it)
                if it % cfg.eval_every == 0:
                    emit(*pending)
                    pending = None
                    run_validation(it)
            if pending is not None:
                emit(*pending)
            best_dice = best
            if not os.path.exists(best_path):
                # a stage shorter than eval_every, or one whose validations
                # never beat 0, still hands a checkpoint on
                best_dice = round(self.validate(state), 4)
                save_many([best_path, last_path], state.model)
                logger.info("end-of-stage save (dice %.4f) to %s", best_dice,
                            best_path)
        finally:
            feeder.close()
            writer.close()
        dt = time.time() - t0
        logger.info("stage %s done: %d steps in %.1fs (%.3f s/step), best "
                    "dice %.4f", stage, max_iterations, dt,
                    dt / max(max_iterations, 1), best_dice)
        return best_dice, best_path

    def pretrain(self) -> Tuple[float, str]:
        return self._run_stage("pre", self.cfg.pre_iterations)

    def selftrain(self) -> Tuple[float, str]:
        return self._run_stage("self", self.cfg.self_iterations,
                               init_from=best_model_path(self.pre_dir,
                                                         self.cfg.net_type))
