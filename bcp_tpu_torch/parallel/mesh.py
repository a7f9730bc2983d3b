"""Data parallelism and spatial partitioning over several ranks:
``bcp_tpu/parallel/mesh.py`` for the port.

In the JAX package a device mesh shards every feed stream on its batch
axis (``data``) and, with ``sp_devices`` S > 1, its leading spatial axis x
over a second ``space`` axis, and replicates the state; XLA's SPMD
partitioner then computes the one-device program on the global batch,
inserting the conv halo exchanges, the reductions and the replication of
levels too small to split. Here each rank is a process with one device
(``cuda:<rank>`` over NCCL, or the CPU over gloo) and the same function of
the global batch is assembled by hand:

- every rank builds the same state from the seed (``check_replicas``
  holds rank 0's against every rank's) and runs the same feeder from the
  same seed, keeping rows ``[d*b, (d+1)*b)`` of every stream, d its data
  index (:func:`shard_rows`, what ``NamedSharding(P('data'))`` does) and,
  under a space split, x slab ``[s*X/S, (s+1)*X/S)`` of them, s its space
  index (:func:`shard_space`, ``P('data', 'space')``);
- every ratio of batch sums in the losses and every BatchNorm statistic is
  taken over the global batch, with one of two reductions;
- the parameter gradients are summed over the ranks, once a step
  (:func:`all_reduce_grads`), before the optimizer step.

The world is a grid of N/S data indices by S space indices, rank r at
(r // S, r % S) as ``make_mesh`` lays its devices out (:func:`set_space`);
the S ranks of one data index form its space group.

**Why sums, and which backward.** Let rank r hold its rows x_r and the
global loss be L = F(S, T), where S = sum_r s_r(x_r, T) collects the loss
sums (sum CE*m, sum m, the per-class Dice sums, ...) and T = sum_r t_r(x_r)
the BatchNorm statistics. Every rank computes S and T by an all-reduce and
so holds the whole L, the value a one-device run computes on the global
batch.

- A loss sum, :func:`sum_ranks` / :func:`mean_ranks`: dL/dS is the same on
  every rank, and rank r's share of it flows into s_r only. Its backward
  passes the gradient through unchanged. (``torch.distributed.nn``'s
  all-reduce sums the gradient over the ranks in its backward and would
  multiply it by N here.)
- A BatchNorm statistic, :func:`mean_statistics`: the statistic feeds
  every rank's normalised rows, but rank r's backward only sees its own
  rows' share of dL/dT. The true dL/dT is the sum of the shares, so the
  backward all-reduces the gradient (as ``SyncBatchNorm`` does).
- The parameter gradient of L is then the SUM of the ranks' gradients,
  not their mean: DDP's averaging would be wrong for every ratio of sums
  (``dice_loss_per_class``, the masked CE), and N times too small for the
  rest.

Every rank holds the same per-device batch, so a global mean is the mean
of the ranks' means: the port all-reduces means and divides by N, which
in a world of one is the one-device path bit for bit.

**Under a space split** these reductions compose unchanged: every slab
holds an equal share of its level's voxels, so a mean over the world of
the ranks' means (a BatchNorm statistic, ``cross_entropy_mean``) is the
global mean, and a sum over the world (the ratio-of-sums losses,
pancreas' ``train_dice``) is the global sum. What is per sample is
summed over the space group alone, with the statistic's backward
(:func:`sum_space`: instance norm's statistics, ``masked_dice_loss``'s
sums); the value is then the same on the S ranks of a sample, and a world
mean of it counts each data index S times, as it should. The 3^3 convs
read one plane of each neighbour's slab (:func:`halo`, whose backward
sends each halo plane's gradient back to its owner), and a level whose
slab cannot be halved is gathered (:func:`gather_space`, backward the
summed reduce-scatter) and run replicated on the S ranks
(``models.layers.SpaceLevels``). There a world mean of statistics is
still the global one (each data index's value counted S times), and the
summed gradient is still exact: rank r's copy feeds only rank r's slab
downstream, so the S copies' gradients add up to the one-device
gradient. :func:`split` turns the split off (validation, the replicated
levels).

**Where collectives are issued.** All from the training thread, in
program order: the step's (also inside the CUDA graphs of
``train.graphs``, which capture them on the capture stream) and the
evaluators' (validation runs inline at the eval boundary under a world,
``train.trainer``). One process group (and one space group a rank) then
serves every collective, and two ranks can never issue the same
collectives in different orders. The halo and gather collectives are
all-gathers and reduce-scatters, which NCCL captures in a graph.

A CLI given ``--num_devices N > 1`` spawns its N ranks itself
(:func:`launch`, start method ``spawn``), so one command trains on N
cards, as the JAX CLI does. Outside a world (the default, ``--num_devices
1``) every function here is the identity and the port runs its one-device
path unchanged; chip_smoke runs the world's path in a world of one
(:func:`process_group`).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclass
class World:
    rank: int
    size: int
    device: torch.device
    #: space ranks a data index (:func:`set_space`), and this rank's group
    sp: int = 1
    space_group: Any = None
    #: the space split is on (off while validating, and at replicated
    #: levels: :func:`split`)
    split: bool = True


#: this process's world, None outside one: a process joins at most one,
#: as torch.distributed keeps one default process group a process
_WORLD: Optional[World] = None
#: how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


def active() -> bool:
    return _WORLD is not None


def rank() -> int:
    return 0 if _WORLD is None else _WORLD.rank


def world_size() -> int:
    return 1 if _WORLD is None else _WORLD.size


def is_main() -> bool:
    """Rank 0 (or no world): the rank that writes logs and files."""
    return rank() == 0


def space_size() -> int:
    """S, the ranks a sample's volume is split over (1 without a split)."""
    return 1 if _WORLD is None else _WORLD.sp


def data_size() -> int:
    """The data indices, N / S: the global batch's reference batches."""
    return world_size() // space_size()


def data_index() -> int:
    return rank() // space_size()


def space_index() -> int:
    return rank() % space_size()


def space_split() -> bool:
    """The tensors of the running code are x slabs: a space split is set
    and not turned off (:func:`split`)."""
    return _WORLD is not None and _WORLD.sp > 1 and _WORLD.split


def set_space(sp: int) -> None:
    """Lay the world out as N/S data indices by ``sp`` space indices, rank
    r at (r // sp, r % sp) (``make_mesh``, `mesh.py:43-64`). Every rank
    calls it with the same ``sp`` (it creates every space group, in
    order, as ``dist.new_group`` wants); the same ``sp`` again is a
    no-op."""
    sp = max(int(sp), 1)
    if _WORLD is None:
        if sp > 1:
            raise ValueError(f"sp_devices={sp} needs a world of ranks")
        return
    if sp == _WORLD.sp:
        return
    if _WORLD.size % sp:
        raise ValueError(f"sp_devices={sp} must divide the mesh size "
                         f"{_WORLD.size}")
    group = None
    if sp > 1:
        for d in range(_WORLD.size // sp):
            g = dist.new_group(list(range(d * sp, (d + 1) * sp)))
            if d == _WORLD.rank // sp:
                group = g
    _WORLD.sp, _WORLD.space_group = sp, group


@contextlib.contextmanager
def split(on: bool) -> Iterator[None]:
    """Run the block with the space split on or off (no-op without one):
    off for validation, which shards windows or slices over every rank
    (``flat_mesh``, `mesh.py:66-72`), and for a replicated level."""
    if _WORLD is None or _WORLD.sp == 1:
        yield
        return
    old, _WORLD.split = _WORLD.split, bool(on)
    try:
        yield
    finally:
        _WORLD.split = old


def resolve_count(n: int, device=None) -> int:
    """The ranks of ``--num_devices n``: ``-1`` is every visible card;
    on the CPU (gloo) ranks are processes and ``n`` must be given. Asking
    for more cards than are visible raises (`trainer.py:147-153`): the port
    never runs on fewer."""
    dev = torch.device("cuda" if device is None else device)
    n = int(n)
    if n in (0, 1):
        return 1
    if dev.type == "cpu":
        if n < 1:
            raise ValueError(f"num_devices={n}: on the CPU give the number "
                             f"of ranks")
        return n
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == -1:
        n = visible
    if n < 1 or n > visible:
        raise ValueError(f"num_devices={n} but only {visible} CUDA devices "
                         f"are visible")
    return n


@contextlib.contextmanager
def process_group(rank_: int, size: int, device,
                  init_method: Optional[str] = None,
                  backend: Optional[str] = None) -> Iterator[World]:
    """Join (and on exit leave) a world of ``size`` ranks as ``rank_`` on
    ``device``: NCCL for a card (``cuda:<rank>`` unless an index is
    given), gloo for the CPU, nothing chosen silently; ``backend="gloo"``
    on a card lets several ranks share one card (NCCL refuses that), for
    a check on a machine with one. A collective that waits longer than
    TIMEOUT for the other ranks raises. ``init_method`` defaults to a file
    store in a fresh temporary directory, which only a world of one can
    share."""
    global _WORLD
    if _WORLD is not None or dist.is_initialized():
        raise RuntimeError("this process is already in a world")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank_} cannot reach a CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", rank_)
        torch.cuda.set_device(dev)
    tmp = None
    if init_method is None:
        if size != 1:
            raise ValueError("a world of several ranks needs a shared "
                             "init_method")
        tmp = tempfile.mkdtemp(prefix="bcp_world_")
        init_method = "file://" + os.path.join(tmp, "store")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=size, timeout=TIMEOUT, **kw)
    _WORLD = World(rank_, size, dev)
    try:
        yield _WORLD
    finally:
        _WORLD = None
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank_: int, size: int, device_type: str, tmp: str,
               threads: int, fn: Callable, args: tuple) -> None:
    if device_type == "cpu":
        torch.set_num_threads(threads)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank_)
    with process_group(rank_, size, device,
                       "file://" + os.path.join(tmp, "store")):
        if device_type == "cuda":
            from bcp_tpu_torch import kernels
            kernels.build_for_world()
        out = fn(*args)
    if rank_ == 0:
        with open(os.path.join(tmp, "result.pkl"), "wb") as f:
            pickle.dump(out, f)


def launch(fn: Callable, n: int, device, *args) -> Any:
    """Run ``fn(*args)`` on ``n`` ranks, one spawned process each, and
    return rank 0's result (it must pickle). Rank r runs on ``cuda:r``
    (NCCL) or on the CPU (gloo, each rank with this process's torch threads
    divided by ``n``). A rank that raises or dies ends the others and the
    call raises; the rendezvous is a file store in a temporary directory,
    removed on the way out."""
    import torch.multiprocessing as mp
    dev = torch.device(device)
    n = resolve_count(n, dev)
    threads = max(torch.get_num_threads() // n, 1)
    tmp = tempfile.mkdtemp(prefix="bcp_world_")
    try:
        mp.start_processes(_rank_main,
                           args=(n, dev.type, tmp, threads, fn, args),
                           nprocs=n, join=True, start_method="spawn")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------- rows ----------------
def _part(t: torch.Tensor, axis: int, n: int, i: int,
          what: str) -> torch.Tensor:
    if t.shape[axis] % n:
        raise ValueError(f"{t.shape[axis]} {what} do not split over {n} "
                         f"ranks")
    b = t.shape[axis] // n
    return t.narrow(axis, i * b, b)


def shard_rows(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Data index d's rows ``[d*b, (d+1)*b)`` of a global stream along
    ``axis`` (1 for a K-stacked batch), a view; the whole tensor outside a
    world."""
    if _WORLD is None:
        return t
    return _part(t, axis, data_size(), data_index(), "rows")


def shard_space(t: torch.Tensor, axis: int) -> torch.Tensor:
    """Space index s's x slab ``[s*X/S, (s+1)*X/S)`` of ``t`` along
    ``axis`` (``stream_sharding``'s ``space``, `mesh.py:81-86`), a view;
    ``t`` itself while the split is off. Its backward pads the gradient
    with zeros, so a replicated level's copies each send back their own
    slab's share."""
    if not space_split():
        return t
    return _part(t, axis, _WORLD.sp, space_index(), "planes")


def rank_rows(t: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """This rank's rows of ``t``, drawn for the global concat batch of
    ``groups`` sub-batches: global row layout (group, data index, row), so
    data index d keeps ``t.view(groups, N/S, -1, ...)[:, d]``. What a
    one-device run draws for the global batch, each rank keeps for its own
    rows (the S ranks of a data index the same rows)."""
    if _WORLD is None:
        return t
    D = data_size()
    rest = t.shape[1:]
    g = t.reshape(groups, D, t.shape[0] // (groups * D), *rest)
    return g[:, data_index()].reshape(-1, *rest)


# ---------------- the two reductions ----------------
class _SumLossParts(torch.autograd.Function):
    """all-reduce SUM; the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


class _SumStatistics(torch.autograd.Function):
    """all-reduce SUM; the gradient is summed over the ranks too."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def sum_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of a loss part (every rank gets it); its
    gradient reaches each rank's part unchanged."""
    return x if _WORLD is None else _SumLossParts.apply(x)


def mean_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of a per-rank mean of a loss part (the
    global mean, every rank holding the same rows)."""
    return x if _WORLD is None else _SumLossParts.apply(x) / _WORLD.size


def mean_statistics(x: torch.Tensor) -> torch.Tensor:
    """The global mean of a BatchNorm statistic from each rank's mean; its
    backward sums the gradient over the ranks."""
    return x if _WORLD is None else _SumStatistics.apply(x) / _WORLD.size


# ---------------- the space group ----------------
# the tensor collectives under the names torch gives them now, where it does
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


class _SumSpace(torch.autograd.Function):
    """all-reduce SUM over the space group; the gradient is summed over
    it too (the statistic feeds every slab of the sample)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, group=_WORLD.space_group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_WORLD.space_group)
        return g


def sum_space(x: torch.Tensor) -> torch.Tensor:
    """The sum over the space group of a per-sample partial sum (instance
    norm's statistics, ``masked_dice_loss``'s sums): the whole volume's,
    the same on the S ranks of the sample; its backward sums the
    gradient over the group. ``x`` itself while the split is off."""
    return _SumSpace.apply(x) if space_split() else x


def _gather_planes(t: torch.Tensor) -> torch.Tensor:
    """(S, *t.shape): every space rank's ``t``, in space order."""
    t = t.contiguous()
    out = t.new_empty((_WORLD.sp * t.shape[0], *t.shape[1:]))
    _all_gather_single(out, t, group=_WORLD.space_group)
    return out.view(_WORLD.sp, *t.shape)


def _layout(t: torch.Tensor) -> torch.memory_format:
    """The memory format the port keeps ``t`` in (channels-last on the
    card), to give a new tensor of another shape the same one."""
    if t.dim() in (4, 5) and not t.is_contiguous():
        fmt = (torch.channels_last if t.dim() == 4
               else torch.channels_last_3d)
        if t.is_contiguous(memory_format=fmt):
            return fmt
    return torch.contiguous_format


def pad_slab(x: torch.Tensor, left: Optional[torch.Tensor],
             right: Optional[torch.Tensor]) -> torch.Tensor:
    """x's slab (dim 2) with the plane ``left`` before it and ``right``
    after it (None: a zero plane, the volume's end), in x's layout: what
    the halo exchange feeds a conv that is VALID in x."""
    y = F.pad(x, (0, 0) * (x.dim() - 3) + (1, 1)).contiguous(
        memory_format=_layout(x))
    if left is not None:
        y[:, :, 0] = left
    if right is not None:
        y[:, :, -1] = right
    return y


def fold_slab(g: torch.Tensor, left: Optional[torch.Tensor],
              right: Optional[torch.Tensor]) -> torch.Tensor:
    """The gradient of a slab from the gradient ``g`` of its padded slab:
    g's inner planes, plus on the first plane ``left`` and on the last
    ``right``, the gradients of the halo planes the neighbours took of
    them (None: no neighbour)."""
    dx = g[:, :, 1:-1].contiguous(memory_format=_layout(g))
    if left is not None:
        dx[:, :, 0] += left
    if right is not None:
        dx[:, :, -1] += right
    return dx


def halo_slabs(x: torch.Tensor, S: int) -> list:
    """The S halo-padded slabs of the whole ``x`` (dim 2) in one process:
    each slab through :func:`pad_slab` with its neighbours' planes cut from
    ``x``, what the S ranks' exchanges give their convs (the tests and
    chip_smoke hold the slabs' convs against the whole volume's)."""
    n = x.shape[2] // S
    return [pad_slab(x[:, :, s * n:(s + 1) * n],
                     x[:, :, s * n - 1] if s > 0 else None,
                     x[:, :, (s + 1) * n] if s < S - 1 else None)
            for s in range(S)]


def fold_slabs(grads: list) -> torch.Tensor:
    """The whole volume's gradient from the gradients of the S padded slabs
    of :func:`halo_slabs`, in one process: each through :func:`fold_slab`
    with the halo gradients its neighbours send back."""
    S = len(grads)
    return torch.cat([fold_slab(g, grads[s - 1][:, :, -1] if s > 0 else None,
                                grads[s + 1][:, :, 0] if s < S - 1 else None)
                      for s, g in enumerate(grads)], 2)


class _HaloExchange(torch.autograd.Function):
    """(B, C, Xs, ...) slab -> (B, C, Xs + 2, ...): one plane of each
    neighbour's slab on either side, zeros at the volume's two ends. One
    all-gather of every rank's two boundary planes (the same all-gather
    serves any S, and NCCL captures it in a graph). The backward sends
    each halo plane's gradient back to its owner, which adds it to its
    boundary plane."""

    @staticmethod
    def _neighbours(t: torch.Tensor):
        """(the left neighbour's last plane, the right one's first) of
        t's boundary planes over the space group, None at an end."""
        S, s = _WORLD.sp, space_index()
        planes = _gather_planes(torch.stack([t[:, :, 0], t[:, :, -1]]))
        return (planes[s - 1, 1] if s > 0 else None,
                planes[s + 1, 0] if s < S - 1 else None)

    @staticmethod
    def forward(ctx, x):
        return pad_slab(x, *_HaloExchange._neighbours(x))

    @staticmethod
    def backward(ctx, g):
        # the left neighbour's last halo plane is the gradient of this
        # slab's first plane, the right one's first of its last
        return fold_slab(g, *_HaloExchange._neighbours(g))


def halo(x: torch.Tensor) -> torch.Tensor:
    """x's slab (dim 2) padded with one plane of each neighbour's slab and
    zeros at the volume's ends: what a 3^3 (or 3x3) conv that is VALID in
    x needs to give this slab's planes of the SAME conv of the whole
    volume. Only under a space split."""
    if not space_split():
        raise RuntimeError("halo() needs a space split")
    return _HaloExchange.apply(x)


class _GatherSpace(torch.autograd.Function):
    """all-gather of the slabs along ``axis`` over the space group; the
    backward is the summed reduce-scatter (each rank's copy of the whole
    contributes its gradient to every slab)."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis, ctx.fmt = axis, _layout(t)
        parts = _gather_planes(t.movedim(axis, 0))      # (S, Xs, ...)
        whole = parts.flatten(0, 1).movedim(0, axis)
        return whole.contiguous(memory_format=ctx.fmt)

    @staticmethod
    def backward(ctx, g):
        src = g.movedim(ctx.axis, 0).contiguous()
        out = src.new_empty((src.shape[0] // _WORLD.sp, *src.shape[1:]))
        _reduce_scatter_single(out, src, group=_WORLD.space_group)
        return out.movedim(0, ctx.axis).contiguous(memory_format=ctx.fmt), \
            None


def gather_space(t: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """The whole volume along ``axis`` from the space group's slabs (in
    t's layout); ``t`` itself while the split is off."""
    return _GatherSpace.apply(t, axis) if space_split() else t


# ---------------- plain collectives ----------------
def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Sum every parameter's gradient over the ranks: one all-reduce of
    the flattened gradients."""
    if _WORLD is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place."""
    if _WORLD is not None:
        dist.all_reduce(t)
    return t


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in rank order."""
    if _WORLD is None:
        return t
    parts = [torch.empty_like(t) for _ in range(_WORLD.size)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (a validation score, so that every
    rank takes rank 0's best-model decision)."""
    if _WORLD is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    if _WORLD is not None:
        dist.barrier()


def _state_bytes(tensors: Iterable[torch.Tensor],
                 device: torch.device) -> torch.Tensor:
    parts = [t.detach().to(device).contiguous().reshape(-1).view(torch.uint8)
             for t in tensors]
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8,
                                                      device=device)


def check_replicas(named: Dict[str, Iterable[torch.Tensor]]) -> None:
    """Raise on every rank unless each rank's tensors equal rank 0's bit for
    bit (``named``: part name -> its tensors, e.g. the student's and the
    teacher's state_dict values and the optimizer's state)."""
    if _WORLD is None:
        return
    bad = []
    for name, tensors in named.items():
        mine = _state_bytes(list(tensors), _WORLD.device)
        size = torch.tensor([mine.numel()], device=_WORLD.device)
        dist.broadcast(size, src=0)
        ref = (mine.clone() if _WORLD.rank == 0 else
               torch.empty(int(size.item()), dtype=torch.uint8,
                           device=_WORLD.device))
        dist.broadcast(ref, src=0)
        same = ref.numel() == mine.numel() and torch.equal(ref, mine)
        flag = torch.tensor([0 if same else 1], device=_WORLD.device)
        dist.all_reduce(flag)
        if flag.item():
            bad.append(f"{name} ({int(flag.item())} rank(s))")
    if bad:
        raise RuntimeError(f"rank {_WORLD.rank}: the replicas differ from "
                           f"rank 0's: {', '.join(bad)}")
