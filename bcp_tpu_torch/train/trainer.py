"""The two-stage BCP trainer: ``bcp_tpu/train/trainer.py``'s LA, ACDC and
pancreas paths for the port.

Copy-paste pre-training, then bidirectional copy-paste mean-teacher
self-training from the pre-train stage's best checkpoint, with validation
every ``eval_every`` steps, best-Dice checkpoints, and an end-of-stage
validation when a stage saved no best model (`trainer.py:271-590`). LA
validates with the sliding-window evaluator on the test split (mean Dice,
as the reference does), ACDC with the per-slice evaluator on the val split
(per-class Dice and HD95; the score is the mean Dice over the classes,
`trainer.py:238-256`), pancreas with the sliding-window evaluator's
argmax rule on the test list, each volume centre-cropped to the patch
(`trainer.py:209-231,259-267`). The self-train stage starts from the
pre-train best's weights (LA) or from its weights and optimizer (ACDC's
momentum buffers, pancreas' Adam moments and step count;
``cfg.load_opt_state``). Step losses are read back one step late, so the
host enqueues step i+1 before it waits for step i's numbers; pancreas
feeds them to its per-epoch meters (`trainer.py:414-447`) from that same
read-back.

With ``cfg.async_val`` (the default, as in the JAX package) validations
and checkpoint writes run on background workers in submission order
(``utils.worker.OrderedWorker``): which states are validated, the
best-Dice sequence and the files written are those of the inline loop,
only the training loop no longer waits. Each eval boundary copies the train state on the
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

``cfg.steps_per_dispatch`` = K > 1 makes K updates per host visit
(`trainer.py:319-325,457-531`; ``train.graphs``): the feed yields K
iterations' batches at once, each sub-step draws what K = 1 draws at its
iteration, and the group's losses are read back once, a group late. On
the card the groups after a stage's first run as CUDA graph replays; on
the CPU as K eager steps. ``eval_every`` and a stage's remaining
iterations must be multiples of K; validation runs at a group's end.

``cfg.profile_dir`` traces the steps of ``cfg.profile_steps`` = (a, b),
counted from the stage's first step, as `trainer.py:459-460,528-531`
does: from before the group that holds step a to after the group that
holds step b has been enqueued, with ``torch.profiler`` (CPU and, on the
card, CUDA activity) into ``<profile_dir>/<stage>_steps_<a>_<b>.json``.
``cfg.debug_nans`` checks every step's losses when they are read back and
raises ``FloatingPointError`` naming the first step whose losses are not
finite. Unlike ``jax_debug_nans``, which re-runs the op that made a NaN,
it sees the step's outputs only, and a group (K steps) later.

In a world of N ranks (``parallel.mesh``; the CLIs' ``--num_devices``)
each rank runs this trainer on its rows of a global batch N times the
reference's (`trainer.py:116-167,304-331`): the feed widens every stream
by N (``data_scale``) and each rank keeps its rows, the steps compute the
global batch's statistics, losses and gradient, and every rank's state
is checked against rank 0's once a stage has loaded it. Validation runs
inline at the eval boundary on every rank (the evaluators shard windows
or slices over the ranks); its collectives are then issued from the
training thread at a fixed point, never from a worker beside the step's,
so no two ranks can order them differently. Every rank takes rank 0's
score. Rank 0 alone writes the logs, ``log.txt``, the metric writer's
output, the checkpoints, ``last_state.pt``, the image snapshots and
profiles, and every rank waits for it at the end of a stage, so the self
stage reads the pre-train best once it is whole; ``resume`` reads the
same ``last_state.pt`` on every rank.

With ``cfg.sp_devices`` S > 1 (`trainer.py:153-166,308-313`) the world is
N/S data indices by S space indices (``mesh.set_space``): the global
batch is N/S reference batches, a data index's rows are split into x
slabs over its S ranks (the feed's ``space``), and the step computes the
one-device update of the global batch through the halo exchanges and
gathers of ``parallel.mesh``. S must divide N and the patch's x extent.
Validation runs with the split off (``flat_mesh``, JAX `mesh.py:66-72`):
the evaluators shard windows or slices over all N ranks as without it.

``log_images=True`` writes the reference's TensorBoard image panels
(``train.snapshots``; `trainer.py:465-486,633-680`) at its cadences: LA
self-train at ``it % eval_every == 1``, ACDC both stages every 20
iterations, none for LA pre-train or pancreas. A due iteration's panels
are taken before its update, from the pre-update state, the iteration's
own mask and (LA) its teacher's pseudo-labels, also inside a K-step group,
where they come between that sub-step's NMS and its update; ACDC's feed
then ships the unlabelled slices' true labels (``ulab_a`` / ``ulab_b``),
which the loop takes out of the batch before the step.
"""

from __future__ import annotations

import math
import os
import time
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.data.datasets import (ACDCDataset, LAHeartDataset,
                                         PancreasDataset)
from bcp_tpu_torch.data.feed import BCPBatchFeeder
from bcp_tpu_torch.data.transforms import pancreas_test_transform
from bcp_tpu_torch.device import resolve_device
from bcp_tpu_torch.convert import load_reference_checkpoint
from bcp_tpu_torch.eval.slice2d import Slice2DEvaluator
from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator
from bcp_tpu_torch.ops.masks import (Box, boxes_mask, cuboid_sizes,
                                     cuboid_starts, fixed_starts, grid_boxes,
                                     grid_starts, slab_box, slab_start)
from bcp_tpu_torch.ops.ramps import sigmoid_rampup
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train.checkpoints import (STATE_FILE, best_model_path,
                                             load_optimizer_state,
                                             restore_state, save_many,
                                             scan_best_dice, snapshot,
                                             snapshot_dir)
from bcp_tpu_torch.train.graphs import DispatchGroups, check_dispatch
from bcp_tpu_torch.train.snapshots import (la_snapshot_grid,
                                           make_acdc_snapshot,
                                           make_la_snapshot)
from bcp_tpu_torch.train.state import (TrainState, build_model, init_state,
                                       load_weights_only, load_with_opt)
from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
from bcp_tpu_torch.utils.logging import (MetricWriter, cut_pre_measures,
                                         cutmix_ft_measures, null_logger,
                                         setup_logging)
from bcp_tpu_torch.utils.worker import OrderedWorker


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


def copy_paste_box(cfg: Config, rng: np.random.Generator) -> List[Box]:
    """The iteration's copy-paste boxes, each (starts, sizes), drawn from
    ``rng`` as `steps.py:83-98` dispatches on ``cfg.mask_kind``: one box
    for ``"ratio"`` (LA's and ACDC's ``mask_ratio`` cuboid), ``"fixed"``
    (pancreas' ``mask_patch`` cube) and ``"slab"`` (3-D: the z-slab of 8/27;
    2-D: the row slab of 4/9), ``3**ndim`` for ``"grid"``."""
    patch = cfg.patch_size
    kind = cfg.mask_kind
    if kind == "fixed":
        return [(fixed_starts(rng, patch, cfg.mask_patch),
                 (int(cfg.mask_patch),) * len(patch))]
    if kind == "grid":
        return grid_boxes(patch, grid_starts(rng, patch))
    if kind == "slab":
        axis, frac = (-1, 8.0 / 27.0) if len(patch) == 3 else (0, 4.0 / 9.0)
        return [slab_box(patch, slab_start(rng, patch, axis, frac), axis,
                         frac)]
    if kind != "ratio":
        raise ValueError(f"unknown mask_kind {kind!r}")
    return [(cuboid_starts(rng, patch, cfg.mask_ratio),
             cuboid_sizes(patch, cfg.mask_ratio))]


def copy_paste_mask(cfg: Config, rng: np.random.Generator, device=None):
    """The iteration's copy-paste mask: 0 in the boxes of
    :func:`copy_paste_box`, 1 elsewhere (``ops.masks.boxes_mask``)."""
    return boxes_mask(cfg.patch_size, copy_paste_box(cfg, rng), device)


class BCPTrainer:
    """``train_dataset`` (``len`` + ``sample_train``; for pancreas a
    (labelled, unlabelled) pair of ``PancreasDataset`` or ``PancreasList``)
    and ``val_cases`` ((image, label) pairs; pancreas' are centre-cropped
    here, as the test volumes read from disk) default to the variant's
    train split and its validation split (LA's and pancreas' test list,
    ACDC's val list) under ``cfg.root_path``. ``on_step(stage,
    iteration)``, when given, is called
    after each iteration has enqueued its step and read back the step
    before it, ahead of that iteration's validation (with K steps a
    dispatch, once for each of a group's iterations after the group is
    enqueued); ``chip_smoke.py`` times and traces the loop's steps with it.
    ``on_metrics(stage, iteration, losses)``, when given, is called with
    each step's losses (host floats) as they are read back.
    ``log_images`` turns on the image snapshots."""

    def __init__(self, cfg: Config, device=None, train_dataset=None,
                 val_cases: Optional[List[Tuple[np.ndarray, np.ndarray]]]
                 = None,
                 on_step: Optional[Callable[[str, int], None]] = None,
                 on_metrics: Optional[Callable[[str, int, Dict[str, float]],
                                               None]] = None,
                 log_images: bool = False):
        if cfg.variant not in ("la", "acdc", "pancreas"):
            raise ValueError(f"unknown variant {cfg.variant!r}")
        if cfg.remat and cfg.net_type not in ("VNet", "VNet_pancreas"):
            # `trainer.py:177-182`
            raise ValueError(f"remat targets the V-Net pipelines; net_type="
                             f"{cfg.net_type!r} has no remat support")
        self.world = mesh.world_size()
        if cfg.num_devices not in (-1, 0, self.world):
            raise ValueError(
                f"num_devices={cfg.num_devices} but this process is in a "
                f"world of {self.world}: start the ranks with "
                f"parallel.mesh.launch (the CLIs' --num_devices)")
        sp = max(int(cfg.sp_devices), 1)
        if sp > 1 and self.world < sp:
            # `trainer.py:157-166`
            raise ValueError(
                f"sp_devices={sp} needs a mesh with a matching 'space' "
                f"axis: pass num_devices >= sp_devices (got num_devices="
                f"{cfg.num_devices}, world of {self.world})")
        if sp > 1 and cfg.patch_size[0] % sp:
            raise ValueError(f"sp_devices={sp} must divide the patch's "
                             f"leading spatial extent {cfg.patch_size[0]}")
        mesh.set_space(sp)
        #: the feed's stream widening, the global batch's reference batches
        self.data_scale = self.world // sp
        self.cfg = cfg
        self.log_images = log_images
        self.device = resolve_device(device)
        self.pre_dir = snapshot_dir(cfg, "pre_train")
        self.self_dir = snapshot_dir(cfg, "self_train")
        self.train_dataset = train_dataset
        self._val_cases = (None if val_cases is None
                           else self._val_prepared(val_cases))
        self.on_step = on_step
        self.on_metrics = on_metrics
        #: stage -> its CUDA graph captures and replays (K > 1 on the card)
        self.graph_counts: Dict[str, Dict[str, int]] = {}
        self.eval_model = build_model(cfg, "test", self.device)
        if cfg.dims == 3:
            self.evaluator = SlidingWindowEvaluator(
                self.eval_model, cfg.patch_size, cfg.num_classes,
                cfg.stride_xy, cfg.stride_z, batch=cfg.eval_batch,
                device=self.device)
        else:
            self.evaluator = Slice2DEvaluator(
                self.eval_model, cfg.patch_size, cfg.num_classes,
                device=self.device)
        #: validations run (the background warm-ups included), for callers
        #: that count kernel launches
        self.validations = 0
        # the device store is the same for both stages: upload it once
        self.feed_store_cache: dict = {}
        self._workers: List[OrderedWorker] = []

    # ---------------- validation ----------------
    def _load_val_cases(self):
        cfg = self.cfg
        if self._val_cases is None:
            if cfg.variant == "acdc":
                ds = ACDCDataset(cfg.root_path, "val")
            elif cfg.variant == "pancreas":
                ds = PancreasDataset(cfg.root_path, "test", cache=False)
            else:
                ds = LAHeartDataset(cfg.root_path, "test")
            self._val_cases = self._val_prepared(
                [ds.load(i) for i in range(len(ds))])
        return self._val_cases

    def _val_prepared(self, cases):
        """Pancreas validates on centre-cropped volumes
        (`trainer.py:223-230`); LA and ACDC on the volumes as read."""
        if self.cfg.variant != "pancreas":
            return cases
        return [pancreas_test_transform(img, lab, self.cfg.patch_size)
                for img, lab in cases]

    def validate(self, state: TrainState) -> float:
        """The student's validation score (`var_all_case_LA`, or ACDC's
        mean Dice over classes)."""
        return self._validate_weights(state.model.state_dict())[0]

    def _validate_weights(self, weights, ready=None):
        """(score, per-class (dice, hd95) array or None) of the eval model
        under ``weights`` (a student's state_dict), on the calling thread's
        stream once ``ready`` (the CUDA event of the weights' copy, if any)
        has passed. LA: the mean Dice over the cases. ACDC: the per-class
        (dice, hd95) averaged over the volumes, whose zoomed images stay on
        the device between validations, and the mean of its Dice column."""
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        self.eval_model.load_state_dict(weights)
        self.validations += 1
        # every rank evaluates whole windows or slices
        with mesh.split(False):
            if self.cfg.variant == "acdc":
                per_class = np.mean(self.evaluator.validate_volumes(
                    self._load_val_cases(), cache=True), axis=0)
                out = float(per_class[:, 0].mean()), per_class
            else:
                out = self.evaluator.validate_dice(
                    self._load_val_cases(), rule=self.cfg.eval_rule), None
        # every rank takes rank 0's score, and so its best-model decision
        return mesh.broadcast_object(out)

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
        main = mesh.is_main()     # rank 0 writes every file
        if main:
            os.makedirs(out_dir, exist_ok=True)
        logger = setup_logging(out_dir) if main else null_logger()
        writer = MetricWriter(os.path.join(out_dir, "log") if main else None)
        logger.info("config: %s", cfg)
        state = init_state(cfg, self.device)
        if init_from is not None:
            weights = load_reference_checkpoint(init_from, cfg.net_type)
            if cfg.load_opt_state:
                # student and optimizer (`ACDC_BCP_train.py:335-336`)
                load_with_opt(state, weights, load_optimizer_state(init_from))
            else:
                # weights only (`LA_BCP_train.py:220-222`)
                load_weights_only(state, weights)
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
        if mesh.active():
            mesh.check_replicas({
                "student": state.model.state_dict().values(),
                "teacher": state.teacher.state_dict().values(),
                "optimizer": [v for st in state.optimizer.state.values()
                              for v in st.values()
                              if isinstance(v, torch.Tensor)]})
            logger.info("mesh over %d devices: data=%d space=%d (global "
                        "batch %d)", self.world, self.data_scale,
                        mesh.space_size(),
                        cfg.batch_size * self.data_scale)
        K = check_dispatch(cfg, max_iterations - state.step)
        dataset = self.train_dataset
        if dataset is None and cfg.variant == "pancreas":
            dataset = (PancreasDataset(cfg.root_path, "train_lab"),
                       PancreasDataset(cfg.root_path, "train_unlab"))
        elif dataset is None:
            dataset = (ACDCDataset if cfg.variant == "acdc" else
                       LAHeartDataset)(cfg.root_path, "train", cache=True)
        feeder = BCPBatchFeeder(cfg, stage, dataset, self.device,
                                store_cache=self.feed_store_cache, stack=K,
                                side_labels=self.log_images and (
                                    main or mesh.space_size() > 1),
                                data_scale=self.data_scale,
                                rank=(mesh.data_index() if mesh.active()
                                      else None),
                                space=(mesh.space_index(),
                                       mesh.space_size()))
        logger.info("%d iterations per epoch (device-store init %.1fs)",
                    feeder.steps_per_epoch, feeder.store_init_s)
        stage_seed = cfg.seed + (0 if stage == "pre" else 1)
        dropout_gen = torch.Generator(device=self.device)
        best = resumed_best     # written by validation jobs, in order
        best_path = best_model_path(out_dir, cfg.net_type)
        last_path = os.path.join(out_dir, "last.pth")
        # the reference's scalar tags: LA `pre/*`, `Self/*`
        # (`LA_BCP_train.py:164-166,261-263`), ACDC `info/*`
        # (`ACDC_BCP_train.py:259-261,392-394`; `trainer.py:592-630`)
        meters = None
        if cfg.variant == "acdc":
            tags = {"loss": "info/total_loss", "loss_dice": "info/mix_dice",
                    "loss_ce": "info/mix_ce"}
        elif cfg.variant == "pancreas":
            # scalars through the meters (`pancreas_utils.py:146-149`)
            tags = {}
            meters = (cut_pre_measures if stage == "pre" else
                      cutmix_ft_measures)(writer, logger)
        elif stage == "pre":
            tags = {"loss_dice": "pre/loss_dice", "loss_ce": "pre/loss_ce",
                    "loss": "pre/loss_all"}
        else:
            tags = {"loss_l": "Self/loss_l", "loss_u": "Self/loss_u",
                    "loss": "Self/loss_all"}
        with_opt = cfg.load_opt_state

        def emit(it: int, metrics) -> None:
            host = {k: float(v) for k, v in metrics.items()}
            bad = sorted(k for k, v in host.items() if not math.isfinite(v))
            if cfg.debug_nans and bad:
                raise FloatingPointError(
                    f"{stage}-train step {it}: non-finite {', '.join(bad)} "
                    f"({host})")
            if self.on_metrics is not None:
                self.on_metrics(stage, it, host)
            if meters is not None:
                # every step, averaged per epoch (`trainer.py:432-447`)
                if (it - 1) % feeder.steps_per_epoch == 0:
                    meters.reset()
                if stage == "pre":
                    meters.update(ce_loss=host["loss_ce"],
                                  dice_loss=host["loss_dice"],
                                  loss_all=host["loss"],
                                  train_dice=host["train_dice"])
                else:
                    meters.update(mix_loss_lab=host["loss_l"],
                                  mix_loss_unlab=host["loss_u"],
                                  loss_all=host["loss"])
                meters.log((it - 1) // feeder.steps_per_epoch + 1, it)
            elif it % cfg.log_every == 0:
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
            dice, per_class = self._validate_weights(snap["model"], ready)
            t_eval = time.time() - tv
            tc = time.time()
            if dice > best:
                best = round(dice, 4)
                tagged = os.path.join(out_dir, f"iter_{it}_dice_{best}.pth")
                io_job = partial(save_many, [tagged, best_path, last_path],
                                 snap, with_opt)
                logger.info("save best model to %s", tagged)
            else:
                io_job = partial(save_many, [last_path], snap, with_opt)
            if ckpt_worker is not None:
                ckpt_worker.submit(io_job)
            else:
                io_job()
            if per_class is not None:
                # `ACDC_BCP_train.py:281-285`
                for c, (c_dice, c_hd95) in enumerate(per_class, start=1):
                    writer.scalar(f"info/val_{c}_dice", float(c_dice), it)
                    writer.scalar(f"info/val_{c}_hd95", float(c_hd95), it)
                writer.scalar("info/val_mean_dice", dice, it)
            elif cfg.variant == "pancreas":
                # `train_pancreas.py:77,136`
                writer.scalar("test_dice" if stage == "pre" else "val_dice",
                              dice, it)
            else:
                writer.scalar("4_Var_dice/Dice", dice, it)
                writer.scalar("4_Var_dice/Best_dice", best, it)
            logger.info("validation@%d: dice %.4f (eval %.2fs, ckpt %.2fs)",
                        it, dice, t_eval, time.time() - tc)

        val_worker = ckpt_worker = warm_job = None
        # under a world the evaluators' collectives run inline, on this
        # thread (module docstring)
        if cfg.async_val and not mesh.active():
            val_worker = OrderedWorker(cfg.async_val_depth, self.device)
            # second ordered stage: the checkpoint writes of validation v
            # run while validation v+1 evaluates
            ckpt_worker = OrderedWorker(cfg.async_val_depth, self.device)
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

        def draws(it: int):
            """Iteration ``it``'s copy-paste box and dropout generator."""
            rng = iteration_draws(stage_seed, it, dropout_gen)
            return copy_paste_box(cfg, rng), dropout_gen

        snaps: List[Tuple[int, Dict[str, torch.Tensor]]] = []

        def snapshot_hook(first: int, ulabs):
            """The groups' ``before_update``: iteration ``it``'s panels
            when they are due (``ulabs``: the batch's true unlabelled
            labels, K-stacked when K > 1); rank 0's rows hold the global
            batch's first samples. Under a space split every rank gathers
            its rows' whole volumes over its space group, and rank 0 makes
            the panels with the split off."""
            sp = mesh.space_size() > 1
            if not (self.log_images and (main or sp)):
                return None

            def hook(it, sub, mask, plab):
                if not self._snapshot_due(it, stage):
                    return
                ul = {k: v if K == 1 else v[it - first]
                      for k, v in ulabs.items()}
                if sp:
                    sub = {k: mesh.gather_space(v, 1 if k.startswith("lab")
                                                else 2)
                           for k, v in sub.items()}
                    ul = {k: mesh.gather_space(v, 1) for k, v in ul.items()}
                    if plab is not None:
                        plab = mesh.gather_space(plab, 1)
                if not main:
                    return
                with mesh.split(False):
                    if cfg.variant == "la":
                        panels = make_la_snapshot(state, sub, mask, plab)
                    else:
                        panels = make_acdc_snapshot(
                            state, sub, mask, cfg, stage, ul.get("ulab_a"),
                            ul.get("ulab_b"))
                snaps.append((it, panels))
            return hook

        def emit_group(first: int, group) -> None:
            names, values = group
            for j, row in enumerate(values.tolist()):
                emit(first + j, dict(zip(names, row)))

        groups = None
        if K > 1:
            groups = DispatchGroups(state, cfg, stage, K, draws,
                                    before_capture=self.wait_for_validations)
        profile = None
        t0 = time.time()
        start = state.step
        val_seconds = 0.0   # exposed validation + checkpoint pauses (wall)
        pending = None
        try:
            for itk in range(start + 1, max_iterations + 1, K):
                it = itk + K - 1      # the group's last iteration
                if cfg.profile_dir and main and \
                        itk <= cfg.profile_steps[0] + start <= it:
                    profile = self._start_profile()
                batch = next(feeder)
                # the true unlabelled labels feed the snapshots only
                ulabs = {k: batch.pop(k) for k in ("ulab_a", "ulab_b")
                         if k in batch}
                hook = snapshot_hook(itk, ulabs)
                if groups is not None:
                    done = partial(emit_group, itk,
                                   groups.run(batch, itk, hook))
                else:
                    mask = copy_paste_mask(
                        cfg, iteration_draws(stage_seed, it, dropout_gen),
                        self.device)
                    if stage == "pre":
                        if hook is not None:
                            hook(it, batch, mask, None)
                        metrics = pretrain_step(state, batch, mask, cfg,
                                                dropout_gen)
                    else:
                        metrics = selftrain_step(
                            state, batch, mask, cfg, dropout_gen,
                            dropout_gen, None if hook is None else
                            partial(hook, it, batch, mask))
                    done = partial(emit, it, metrics)
                for snap_it, panels in snaps:
                    self._emit_snapshot(writer, stage, feeder, snap_it,
                                        panels)
                snaps.clear()
                if stage == "self":
                    for j in range(itk, it + 1):
                        # computed and logged, never applied (reference
                        # parity, `LA_BCP_train.py:246,260`); ACDC's helper
                        # carries a factor 5 (`ACDC_BCP_train.py:119-121`)
                        cw = cfg.consistency * sigmoid_rampup(
                            j // 150, cfg.consistency_rampup)
                        if cfg.variant == "acdc":
                            writer.scalar("info/consistency_weight",
                                          5.0 * cw, j)
                        else:
                            writer.scalar("Self/consistency", cw, j)
                if warm_job is not None:
                    val_worker.submit(warm_job)
                    warm_job = None
                if pending is not None:
                    pending()
                pending = done
                if self.on_step is not None:
                    for j in range(itk, it + 1):
                        self.on_step(stage, j)
                if profile is not None and itk <= cfg.profile_steps[1] \
                        + start <= it:
                    self._stop_profile(profile, stage, logger)
                    profile = None
                if it % cfg.eval_every == 0:
                    pending()
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
                pending()
            if val_worker is not None:
                tv0 = time.time()
                val_worker.drain()      # may still submit checkpoint jobs,
                ckpt_worker.drain()     # so the I/O stage drains after it
                val_seconds += time.time() - tv0
            best_dice = best
            if not mesh.broadcast_object(os.path.exists(best_path)):
                # a stage shorter than eval_every, or one whose validations
                # never beat 0, still hands a checkpoint on
                best_dice = round(self.validate(state), 4)
                save_many([best_path, last_path], snapshot(state), with_opt)
                logger.info("end-of-stage save (dice %.4f) to %s", best_dice,
                            best_path)
            # the next stage's ranks read what rank 0 wrote
            mesh.barrier()
        finally:
            if profile is not None:   # a range past the stage's end
                self._stop_profile(profile, stage, logger)
            for worker in self._workers:
                worker.close()
            self._workers = []
            if groups is not None:
                self.graph_counts[stage] = groups.close()
            feeder.close()
            writer.close()
        dt = time.time() - t0
        done = max_iterations - start
        logger.info("stage %s done: %d steps in %.1fs (%.3f s/step), "
                    "validation+ckpt pauses %.1fs (%.1f%%), best dice %.4f",
                    stage, done, dt, dt / max(done, 1), val_seconds,
                    100.0 * val_seconds / max(dt, 1e-9), best_dice)
        return best_dice, best_path

    def _snapshot_due(self, it: int, stage: str) -> bool:
        """The reference's image cadences (`trainer.py:633-643`): LA
        self-train at ``it % eval_every == 1`` (`LA_BCP_train.py:294`),
        ACDC both stages every 20 (`ACDC_BCP_train.py:265,399`), no images
        for LA pre-train or pancreas."""
        if self.cfg.variant == "acdc":
            return it % 20 == 0
        if self.cfg.variant == "la" and stage == "self":
            return it % self.cfg.eval_every == 1
        return False

    def _emit_snapshot(self, writer: MetricWriter, stage: str, feeder,
                       it: int, panels: Dict[str, torch.Tensor]) -> None:
        """Hand iteration ``it``'s panels to the writer
        (`trainer.py:662-680`): LA's two grids as
        ``Epoch_{e}_Iter_{i}_{labeled,unlabel}`` (epoch 0-based), ACDC's
        panels as (1, H, W) f32 images."""
        panels = {k: v.float().cpu().numpy() for k, v in panels.items()}
        if self.cfg.variant == "la":
            epoch = (it - 1) // max(feeder.steps_per_epoch, 1)
            for tag, prefix in (("labeled", "mixl"), ("unlabel", "mixu")):
                writer.images(f"Epoch_{epoch}_Iter_{it}_{tag}",
                              la_snapshot_grid(panels[f"{prefix}_img"],
                                               panels[f"{prefix}_lab"],
                                               panels[f"{prefix}_prob"]))
        else:
            for tag, img in panels.items():
                writer.image(tag, img[None], it)

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, stage: str, logger) -> None:
        cfg = self.cfg
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(cfg.profile_dir, exist_ok=True)
        path = os.path.join(cfg.profile_dir, f"{stage}_steps_"
                            f"{cfg.profile_steps[0]}_{cfg.profile_steps[1]}"
                            f".json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)

    def pretrain(self, resume: bool = False) -> Tuple[float, str]:
        return self._run_stage("pre", self.cfg.pre_iterations, resume=resume)

    def selftrain(self, resume: bool = False) -> Tuple[float, str]:
        return self._run_stage("self", self.cfg.self_iterations,
                               init_from=best_model_path(self.pre_dir,
                                                         self.cfg.net_type),
                               resume=resume)
