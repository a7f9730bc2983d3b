"""K train steps per host visit (``cfg.steps_per_dispatch``): the port's
counterpart of ``_maybe_scan`` (`steps.py:141-167`).

In the JAX package one XLA program runs K updates (a ``lax.scan``). Here a
group of K updates runs as K replays of CUDA graphs of the step, so the
host issues a few dozen launches an update instead of thousands; on the
CPU the same grouped loop runs K eager steps. Either way each sub-step
makes the update the K = 1 loop makes at that iteration: the same batch
(the feed's ``stack=K`` batches are K consecutive draws), the same mask
offsets and dropout keep masks (the caller's ``draws(it)``, the trainer's
``iteration_draws``), the same sequential BN, EMA and optimizer state.
The losses of a group come back leading-stacked, (K, metrics), and are
read once a group.

What a graph would freeze runs outside it, eagerly, into static buffers
the graph reads: the sub-step's batch (copied from the stacked batch), the
copy-paste mask (its boxes are drawn as Python integers; :func:`write_box`),
the dropout keep masks (drawn ahead of the forward from the iteration's
generator, ``layers.draw_keep_masks``). The pre-train step is one graph (mix,
forward, loss, backward, optimizer step). The self-train step is two
graphs around an eager NMS, whose fixpoint reads a flag back every round
(``ops.cc``): graph T, the teacher's forward and its threshold or argmax
(``steps.teacher_masks``); the NMS (``steps.clean_masks``) into a static
buffer; graph S, the student's update (``steps.selftrain_update``: mix,
concat forward, losses, backward, optimizer step, EMA). A caller's
``before_update`` hook (the trainer's image snapshots) runs between the
NMS and graph S, on the pre-update state and the sub-step's own buffers.

The first group of a stage runs eagerly: real updates, the same as K = 1,
which build every kernel library, pick every kernel variant, create the
optimizer's state (SGD's momentum buffers, Adam's moments and its step on
the device) and record the dropouts' mask shapes. Only then is a graph
captured, at its first use; a capture records and updates nothing. The
learning rate is a Python number that a capture freezes (``torch.optim``
turns a tensor rate into a number, a host read a graph cannot hold), so
graph S is captured again when ``lr_at`` changes (LA's self-train decay),
into the same memory pool after the old graph is freed. Before a capture
the trainer's background validation and checkpoint jobs are drained
(``before_capture``), and the capture runs with
``capture_error_mode="thread_local"`` so that the feed's host thread,
which pins memory, cannot break it. A graph that fails to capture or
replay raises: there is no eager fallback on the card.

In a world of several ranks (``parallel.mesh``) the programs hold the
step's collectives: graph T the teacher's BatchNorm statistics (its
train-mode forward normalises by the global batch's), graph S and the
pre-train graph those of the student's forward and backward, the losses
and the gradient all-reduce. A capture records them on the capture stream
like any kernel; every rank captures at the same iterations (a stage's
second group, a learning-rate change), so every rank's graphs hold the
same collectives in the same order. The NMS between them runs eagerly,
whatever its round count on each rank: rank-local, or under a space split
on the teacher's masks gathered over the space group (one all-gather
before its rounds, ``steps.clean_masks``). Under a space split the
graphs also hold the halo exchanges, the gathers of replicated levels and
the space group's sums; the copy-paste mask buffer holds the whole patch
and the steps take its slab; the keep masks are drawn whole and sliced as
the recorded forward's dropouts were.

The kernel wrappers count their launches (``kernels.count_launch``), and a
replay bypasses them: each capture's counts are taken back and added again
at each replay, so the counts stay kernel executions.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from bcp_tpu_torch import kernels
from bcp_tpu_torch.config import Config
from bcp_tpu_torch.models.layers import draw_keep_masks, record_dropout_shapes
from bcp_tpu_torch.ops.masks import Box, boxes_mask, paint_boxes
from bcp_tpu_torch.train.state import TrainState, lr_at
from bcp_tpu_torch.train.steps import (clean_masks, pretrain_step,
                                       selftrain_step, selftrain_update,
                                       teacher_masks)

#: a sub-step's draws: (the copy-paste mask's boxes, each (starts, sizes),
#: the generator its dropouts draw from, seeded for the iteration, or None)
Draws = Tuple[Sequence[Box], Optional[torch.Generator]]

#: ``before_update(it, batch, mask, plab)``: called before a sub-step's
#: update with its iteration, sub-batch, mask and pseudo-labels (None in
#: pre-train); what it keeps it copies, the buffers are reused
BeforeUpdate = Callable[[int, Dict[str, torch.Tensor], torch.Tensor,
                         Optional[torch.Tensor]], None]


def check_dispatch(cfg: Config, remaining: int) -> int:
    """``cfg.steps_per_dispatch`` as K, refused (the JAX package's
    `trainer.py:319-325`) unless it divides ``eval_every`` and the
    ``remaining`` iterations of the stage."""
    K = max(int(cfg.steps_per_dispatch), 1)
    if K > 1 and (cfg.eval_every % K or remaining % K):
        raise ValueError(
            f"eval_every ({cfg.eval_every}) and the remaining iterations "
            f"({remaining}) must be multiples of steps_per_dispatch ({K})")
    return K


def _stack_metrics(metrics: Dict[str, torch.Tensor],
                   names: Sequence[str]) -> torch.Tensor:
    # f64 holds every f32 (and f64) loss exactly
    return torch.stack([metrics[n].to(torch.float64) for n in names])


class PinnedMask:
    """Two pinned host buffers of a copy-paste mask, used in turn, each
    with the event of the last copy made from it. A mask of several boxes
    (a grid's 27) is painted into one and copied to the card, and the
    copy returns at once, queued behind whatever the stream holds; a
    buffer is painted again only once its copy of two masks ago has run,
    so the host may run two masks ahead of the card."""

    def __init__(self, shape: Sequence[int]):
        self.bufs = [torch.empty(tuple(shape), dtype=torch.int32,
                                 pin_memory=True) for _ in range(2)]
        self.copied: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0

    def write(self, mask: torch.Tensor, boxes: Sequence[Box]) -> None:
        i, self.turn = self.turn, self.turn ^ 1
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        mask.copy_(torch.from_numpy(paint_boxes(self.bufs[i].numpy(),
                                                boxes)), non_blocking=True)
        self.copied[i] = torch.cuda.Event()
        self.copied[i].record()


def write_box(mask: torch.Tensor, boxes: Sequence[Box],
              pinned: Optional[PinnedMask] = None) -> torch.Tensor:
    """``ops.masks.boxes_mask`` written into ``mask`` (int32 of the patch's
    shape): 1 everywhere, 0 inside each box. One box is two launches (a
    fill, a slice fill); several (a grid's 27) are painted on the host and
    copied in once, not one launch a box: through ``pinned`` when given
    (the card), else with a blocking copy."""
    if len(boxes) > 1:
        if pinned is not None:
            pinned.write(mask, boxes)
            return mask
        return mask.copy_(boxes_mask(mask.shape, boxes))
    (starts, sizes), = boxes
    mask.fill_(1)
    mask[tuple(slice(int(s), int(s) + int(n))
               for s, n in zip(starts, sizes))] = 0
    return mask


class GraphStep:
    """One stage's update on static buffers: each :meth:`step` writes a
    sub-step's inputs into them and runs the stage's programs. On the card
    a program is a CUDA graph, captured at its first run and replayed;
    on the CPU it is its body, called on the same buffers (what the tests
    hold against the eager step). ``like`` is a sub-batch (shapes and
    dtypes of the static batch), ``shapes`` the (teacher, student)
    dropouts' keep-mask shapes of one forward, ``names`` the metrics'
    order."""

    def __init__(self, state: TrainState, cfg: Config, stage: str,
                 like: Dict[str, torch.Tensor],
                 shapes: Tuple[Sequence, Sequence], names: Sequence[str],
                 before_capture: Optional[Callable[[], None]] = None):
        self.state, self.cfg, self.stage = state, cfg, stage
        self.names = list(names)
        dev = next(state.model.parameters()).device
        self.cuda = dev.type == "cuda"
        self.before_capture = before_capture
        self.batch = {k: torch.empty_like(v) for k, v in like.items()}
        self.mask = torch.empty(tuple(cfg.patch_size), dtype=torch.int32,
                                device=dev)
        # a mask of several boxes goes through pinned buffers on the card
        self.pinned = (PinnedMask(cfg.patch_size)
                       if self.cuda and cfg.mask_kind == "grid" else None)
        self.keep_t = [torch.empty(tuple(s), dtype=torch.bool, device=dev)
                       for s in shapes[0]]
        self.keep_s = [torch.empty(tuple(s), dtype=torch.bool, device=dev)
                       for s in shapes[1]]
        self.plab = None
        if stage == "self":
            n = like["uimg_a"].shape[0] + like["uimg_b"].shape[0]
            # the labels' spatial shape: an x slab under a space split
            self.plab = torch.empty((n, *like["lab_a"].shape[1:]),
                                    dtype=torch.int32, device=dev)
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        #: name -> (graph, its outputs, its launches, its learning rate)
        self.graphs: Dict[str, tuple] = {}
        #: captures made (a recapture at a learning-rate change included)
        self.captures = 0
        self.replays = 0

    # ---------------- the programs ----------------
    def _update(self) -> torch.Tensor:
        keep = self.keep_s or None
        if self.stage == "pre":
            metrics = pretrain_step(self.state, self.batch, self.mask,
                                    self.cfg, dropout=keep)
        else:
            metrics = selftrain_update(self.state, self.batch, self.plab,
                                       self.mask, self.cfg, dropout=keep)
        return _stack_metrics(metrics, self.names)

    def _teacher(self) -> torch.Tensor:
        return teacher_masks(self.state, self.batch, self.cfg,
                             dropout=self.keep_t or None)

    def _run(self, name: str) -> torch.Tensor:
        body = self._update if name == "update" else self._teacher
        if not self.cuda:
            return body()
        lr = (lr_at(self.cfg, self.stage, self.state.step)
              if name == "update" else None)
        if name in self.graphs and self.graphs[name][3] != lr:
            # the rate is frozen in the graph: free it, capture anew into
            # the same pool
            self.graphs.pop(name)[0].reset()
        if name not in self.graphs:
            self._capture(name, body, lr)
        graph, out, launches, _ = self.graphs[name]
        graph.replay()
        kernels.add_launches(launches)
        self.replays += 1
        if name == "update":
            self.state.step += 1
        return out

    def _capture(self, name: str, body, lr) -> None:
        if self.before_capture is not None:
            self.before_capture()
        step = self.state.step
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            out = body()
        # the capture ran the body's Python once: its step count goes back,
        # and its counted launches are the graph's, made at each replay
        self.state.step = step
        launches = {k: v - before.get(k, 0)
                    for k, v in kernels.launch_counts().items()
                    if v != before.get(k, 0)}
        kernels.add_launches({k: -v for k, v in launches.items()})
        self.graphs[name] = (graph, out, launches, lr)
        self.captures += 1

    # ---------------- one sub-step ----------------
    def step(self, sub: Dict[str, torch.Tensor], draws: Draws,
             it: int = 0, before_update: Optional[BeforeUpdate] = None
             ) -> torch.Tensor:
        """One update from the sub-batch ``sub`` with ``draws`` at
        iteration ``it``; returns the metrics (float64, in ``names``
        order), a graph's static output on the card: copy it before the
        next step."""
        boxes, gen = draws
        write_box(self.mask, boxes, self.pinned)
        dev = self.mask.device
        if self.stage == "self":
            # the teacher's forward draws first, as in ``selftrain_step``;
            # both self-train forwards run two BatchNorm groups
            draw_keep_masks(self.state.teacher,
                            [k.shape for k in self.keep_t], gen, dev,
                            out=self.keep_t, groups=2)
        draw_keep_masks(self.state.model, [k.shape for k in self.keep_s],
                        gen, dev, out=self.keep_s,
                        groups=2 if self.stage == "self" else 1)
        for k, v in self.batch.items():
            v.copy_(sub[k])
        if self.stage == "self":
            self.plab.copy_(clean_masks(self._run("teacher"), self.cfg))
        if before_update is not None:
            before_update(it, self.batch, self.mask, self.plab)
        return self._run("update")

    def close(self) -> None:
        for graph, *_ in self.graphs.values():
            graph.reset()
        self.graphs = {}


class DispatchGroups:
    """The K updates of a dispatch group (``run``), with their metrics
    leading-stacked. ``draws(it)`` gives iteration ``it``'s :data:`Draws`.
    ``static`` (default: the state is on the card) runs every group after
    the first through a :class:`GraphStep`; else every group is K eager
    steps (``pretrain_step`` / ``selftrain_step``, as K = 1 runs them)."""

    def __init__(self, state: TrainState, cfg: Config, stage: str, K: int,
                 draws: Callable[[int], Draws],
                 static: Optional[bool] = None,
                 before_capture: Optional[Callable[[], None]] = None):
        self.state, self.cfg, self.stage, self.K = state, cfg, stage, K
        self.draws = draws
        self.device = next(state.model.parameters()).device
        self.static = (self.device.type == "cuda" if static is None
                       else static)
        self.before_capture = before_capture
        self.graph_step: Optional[GraphStep] = None
        self.names: Optional[List[str]] = None
        self._bufs: List[torch.Tensor] = []
        self._next = 0

    def _eager(self, sub, draws: Draws, record: bool, it: int,
               before_update: Optional[BeforeUpdate]):
        boxes, gen = draws
        state, cfg = self.state, self.cfg
        mask = boxes_mask(cfg.patch_size, boxes, self.device)
        with contextlib.ExitStack() as rec:
            if record:
                self._shapes = (
                    rec.enter_context(record_dropout_shapes(state.teacher)),
                    rec.enter_context(record_dropout_shapes(state.model)))
            if self.stage == "pre":
                if before_update is not None:
                    before_update(it, sub, mask, None)
                return pretrain_step(state, sub, mask, cfg, gen)
            hook = (None if before_update is None else
                    lambda plab: before_update(it, sub, mask, plab))
            return selftrain_step(state, sub, mask, cfg, gen, gen, hook)

    def _buffer(self, n_metrics: int, device) -> torch.Tensor:
        # two buffers in turn: a group's metrics are read after the next
        # group has been enqueued
        if not self._bufs:
            self._bufs = [torch.empty((self.K, n_metrics),
                                      dtype=torch.float64, device=device)
                          for _ in range(2)]
        out = self._bufs[self._next]
        self._next ^= 1
        return out

    def run(self, batch: Dict[str, torch.Tensor], first_it: int,
            before_update: Optional[BeforeUpdate] = None
            ) -> Tuple[List[str], torch.Tensor]:
        """K updates at iterations first_it .. first_it + K - 1 from the
        leading-stacked ``batch``: (metric names, (K, metrics) float64).
        ``before_update`` is called before each sub-step's update."""
        out = None
        eager = self.graph_step is None
        for j in range(self.K):
            sub = {k: v[j] for k, v in batch.items()}
            it = first_it + j
            draws = self.draws(it)
            if eager:
                metrics = self._eager(sub, draws, j == 0, it, before_update)
                if self.names is None:
                    self.names = list(metrics)
                vec = _stack_metrics(metrics, self.names)
            else:
                vec = self.graph_step.step(sub, draws, it, before_update)
            if out is None:
                out = self._buffer(len(self.names), vec.device)
            out[j].copy_(vec)
        if eager and self.static:
            self.graph_step = GraphStep(self.state, self.cfg, self.stage,
                                        sub, self._shapes, self.names,
                                        self.before_capture)
        return self.names, out

    def close(self) -> Dict[str, int]:
        """Free the graphs; returns the captures and replays made."""
        step, self.graph_step = self.graph_step, None
        if step is None:
            return {"captures": 0, "replays": 0}
        step.close()
        return {"captures": step.captures, "replays": step.replays}
