"""The LA two-stage BCP trainer: ``bcp_tpu/train/trainer.py``'s LA path for
the port.

Copy-paste pre-training, then bidirectional copy-paste mean-teacher
self-training from the pre-train stage's best checkpoint, with validation
(mean Dice of the slice-1 sliding-window evaluator over the test split, as
the reference does) every ``eval_every`` steps, best-Dice checkpoints, and
an end-of-stage validation when a stage saved no best model
(`trainer.py:271-590`). Step losses are read back one step late, so the
host enqueues step i+1 before it waits for step i's numbers.

With ``cfg.async_val`` (the default, as in the JAX package) validations
and checkpoint writes run on background workers in submission order
(:class:`_ValWorker`): which states are validated, the best-Dice sequence
and the files written are those of the inline loop, only the training
loop no longer waits. Each eval boundary copies the train state on the
training stream (``checkpoints.snapshot``) before the next step updates it
in place; the workers run on CUDA streams of their own, which wait for
that copy's event. ``cfg.async_val=False`` keeps the inline loop.

``resume`` restores a stage's ``last_state.pt`` (student, teacher,
optimizer, step), recovers the best Dice so far from the snapshot names
and goes on from step + 1 (`trainer.py:293-302,454-457`). As in the JAX
package the feed's index stream restarts from its seed. The random draws
of an iteration (the copy-paste mask's offsets and the dropouts' keep
masks) depend on (seed, stage, iteration) alone, as the JAX package's
``fold_in(base_key, it)`` does (:func:`iteration_draws`): a stage resumed
at step s draws at s + 1, s + 2, ... what the uninterrupted stage draws
there. The numbers are numpy's and torch's, not ``jax.random``'s.

``cfg.debug_nans`` and ``cfg.profile_dir`` are not honoured yet (ROADMAP
A1): the trainer refuses them rather than ignore them.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from functools import partial
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
from bcp_tpu_torch.train.checkpoints import (STATE_FILE, best_model_path,
                                             restore_state, save_many,
                                             scan_best_dice, snapshot,
                                             snapshot_dir)
from bcp_tpu_torch.train.state import (TrainState, build_model, init_state,
                                       load_weights_only)
from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
from bcp_tpu_torch.utils.logging import MetricWriter, setup_logging


def iteration_draws(stage_seed: int, it: int,
                    dropout_gen: torch.Generator) -> np.random.Generator:
    """The draws of iteration ``it`` from (stage seed, it) alone, the
    port's counterpart of ``jax.random.fold_in(base_key, it)``
    (`trainer.py:483-495`): seeds ``dropout_gen`` for the iteration and
    returns the numpy generator of its mask offsets."""
    seed = np.random.SeedSequence([stage_seed, it, 1]).generate_state(
        1, np.uint64)[0]
    dropout_gen.manual_seed(int(seed >> 1))
    return np.random.default_rng([stage_seed, it, 0])


class _ValWorker:
    """One background thread running validation or checkpoint jobs
    strictly in submission order (`trainer.py:49-112`). ``depth`` bounds
    the jobs in flight, and so the state snapshots alive on the device: a
    submit blocks only while ``depth`` jobs are unfinished. On a CUDA
    device the jobs run on a stream of the worker's own, so their kernels
    and copies queue beside the training stream's, not behind them; a job
    waits itself for the event of whatever it reads. A job's error is
    re-raised in the submitting thread, at the next submit or drain."""

    def __init__(self, depth: int = 1, device=None):
        self._q: queue.Queue = queue.Queue()
        self._err: Optional[Exception] = None
        self._slots = threading.BoundedSemaphore(max(int(depth), 1))
        self._stream = (torch.cuda.Stream(device) if device is not None
                        and torch.device(device).type == "cuda" else None)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx:
            while True:
                job = self._q.get()
                try:
                    if job is not None and self._err is None:
                        job()
                        if self._stream is not None:
                            # what the job read may be freed once it is done
                            self._stream.synchronize()
                except Exception as e:  # raised again in submit or drain
                    self._err = e
                finally:
                    if job is not None:
                        self._slots.release()
                    self._q.task_done()
                if job is None:
                    return

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, job) -> None:
        """Queue a job, waiting until fewer than ``depth`` are in flight.
        Re-raises a previous job's error instead of queueing onto it."""
        self._raise_pending()
        self._slots.acquire()
        self._q.put(job)

    def drain(self) -> None:
        """Block until every submitted job has finished; re-raise the
        first job error in the caller's thread."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()


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
        if cfg.debug_nans or cfg.profile_dir is not None:
            raise NotImplementedError(
                "debug_nans and profile_dir (with profile_steps) are not "
                "honoured by the port's trainer yet (ROADMAP A1)")
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
        #: validations run (the background warm-ups included), for callers
        #: that count kernel launches
        self.validations = 0
        # the device store is the same for both stages: upload it once
        self.feed_store_cache: dict = {}
        self._workers: List[_ValWorker] = []

    # ---------------- validation ----------------
    def _load_val_cases(self):
        if self._val_cases is None:
            ds = LAHeartDataset(self.cfg.root_path, "test")
            self._val_cases = [ds.load(i) for i in range(len(ds))]
        return self._val_cases

    def validate(self, state: TrainState) -> float:
        """Mean Dice of the student (`var_all_case_LA`)."""
        return self._validate_weights(state.model.state_dict())

    def _validate_weights(self, weights, ready=None) -> float:
        """Mean Dice of the eval model under ``weights`` (a student's
        state_dict), on the calling thread's stream once ``ready`` (the
        CUDA event of the weights' copy, if any) has passed."""
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        self.eval_model.load_state_dict(weights)
        self.validations += 1
        return self.evaluator.validate_dice(self._load_val_cases(),
                                            rule=self.cfg.eval_rule)

    def wait_for_validations(self) -> None:
        """Block until the background validation and checkpoint jobs
        submitted so far are done (no-op for the inline loop); a job's
        error is raised here."""
        for worker in list(self._workers):
            worker.drain()

    def _snapshot(self, state: TrainState):
        """(copy of the state, CUDA event after the copy or None)."""
        snap = snapshot(state)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return snap, ready

    # ---------------- stages ----------------
    def _run_stage(self, stage: str, max_iterations: int,
                   init_from: Optional[str] = None,
                   resume: bool = False) -> Tuple[float, str]:
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
        state_path = os.path.join(out_dir, STATE_FILE)
        resumed_best = 0.0
        if resume and os.path.exists(state_path):
            restore_state(state_path, state)
            # a resumed stage must not write {model}_best_model.pth over a
            # better state: recover the best so far from the snapshot names
            resumed_best = scan_best_dice(out_dir)
            logger.info("resumed from %s at step %d (best dice so far "
                        "%.4f)", state_path, state.step, resumed_best)
        dataset = self.train_dataset
        if dataset is None:
            dataset = LAHeartDataset(cfg.root_path, "train", cache=True)
        feeder = BCPBatchFeeder(cfg, stage, dataset, self.device,
                                store_cache=self.feed_store_cache)
        logger.info("%d iterations per epoch (device-store init %.1fs)",
                    feeder.steps_per_epoch, feeder.store_init_s)
        stage_seed = cfg.seed + (0 if stage == "pre" else 1)
        dropout_gen = torch.Generator(device=self.device)
        best = resumed_best     # written by validation jobs, in order
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

        def run_validation(it: int, snap, ready) -> None:
            """Validate one state copy and write its checkpoints: the body
            of an eval boundary (`trainer.py:354-384`), inline or on the
            validation worker. The best-Dice decision is made here, in
            validation order; with a checkpoint worker only the fetch and
            the disk writes are handed on, so validation v+1 overlaps the
            writes of validation v."""
            nonlocal best
            tv = time.time()
            dice = self._validate_weights(snap["model"], ready)
            t_eval = time.time() - tv
            tc = time.time()
            if dice > best:
                best = round(dice, 4)
                tagged = os.path.join(out_dir, f"iter_{it}_dice_{best}.pth")
                io_job = partial(save_many, [tagged, best_path, last_path],
                                 snap)
                logger.info("save best model to %s", tagged)
            else:
                io_job = partial(save_many, [last_path], snap)
            if ckpt_worker is not None:
                ckpt_worker.submit(io_job)
            else:
                io_job()
            writer.scalar("4_Var_dice/Dice", dice, it)
            writer.scalar("4_Var_dice/Best_dice", best, it)
            logger.info("validation@%d: dice %.4f (eval %.2fs, ckpt %.2fs)",
                        it, dice, t_eval, time.time() - tc)

        val_worker = ckpt_worker = warm_job = None
        if cfg.async_val:
            val_worker = _ValWorker(cfg.async_val_depth, self.device)
            # second ordered stage: the checkpoint writes of validation v
            # run while validation v+1 evaluates
            ckpt_worker = _ValWorker(cfg.async_val_depth, self.device)
            self._workers = [val_worker, ckpt_worker]
            # Warm the evaluator off the critical path (`trainer.py:399-
            # 413`): load the validation volumes, build the evaluator's
            # kernels and count map, so the first eval boundary's job does
            # not carry them. The dice is discarded and no best or
            # checkpoint state is touched. The weights are copied now (the
            # first step updates them in place); the job is submitted after
            # the first step has been enqueued.
            warm_snap, warm_ready = self._snapshot(state)
            warm_job = partial(self._validate_weights, warm_snap["model"],
                               warm_ready)

        t0 = time.time()
        start = state.step
        val_seconds = 0.0   # exposed validation + checkpoint pauses (wall)
        pending = None
        try:
            for it in range(start + 1, max_iterations + 1):
                batch = next(feeder)
                mask_rng = iteration_draws(stage_seed, it, dropout_gen)
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
                if warm_job is not None:
                    val_worker.submit(warm_job)
                    warm_job = None
                if pending is not None:
                    emit(*pending)
                pending = (it, metrics)
                if self.on_step is not None:
                    self.on_step(stage, it)
                if it % cfg.eval_every == 0:
                    emit(*pending)
                    pending = None
                    tv0 = time.time()
                    job = partial(run_validation, it, *self._snapshot(state))
                    if val_worker is not None:
                        val_worker.submit(job)
                    else:
                        job()
                    # the exposed pause only: the copy and any wait for a
                    # slot (background), or the whole validation (inline)
                    val_seconds += time.time() - tv0
            if pending is not None:
                emit(*pending)
            if val_worker is not None:
                tv0 = time.time()
                val_worker.drain()      # may still submit checkpoint jobs,
                ckpt_worker.drain()     # so the I/O stage drains after it
                val_seconds += time.time() - tv0
            best_dice = best
            if not os.path.exists(best_path):
                # a stage shorter than eval_every, or one whose validations
                # never beat 0, still hands a checkpoint on
                best_dice = round(self.validate(state), 4)
                save_many([best_path, last_path], snapshot(state))
                logger.info("end-of-stage save (dice %.4f) to %s", best_dice,
                            best_path)
        finally:
            for worker in self._workers:
                worker.close()
            self._workers = []
            feeder.close()
            writer.close()
        dt = time.time() - t0
        done = max_iterations - start
        logger.info("stage %s done: %d steps in %.1fs (%.3f s/step), "
                    "validation+ckpt pauses %.1fs (%.1f%%), best dice %.4f",
                    stage, done, dt, dt / max(done, 1), val_seconds,
                    100.0 * val_seconds / max(dt, 1e-9), best_dice)
        return best_dice, best_path

    def pretrain(self, resume: bool = False) -> Tuple[float, str]:
        return self._run_stage("pre", self.cfg.pre_iterations, resume=resume)

    def selftrain(self, resume: bool = False) -> Tuple[float, str]:
        return self._run_stage("self", self.cfg.self_iterations,
                               init_from=best_model_path(self.pre_dir,
                                                         self.cfg.net_type),
                               resume=resume)
