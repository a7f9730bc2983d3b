"""Data parallelism over several ranks: ``bcp_tpu/parallel/mesh.py`` for the
port, without spatial partitioning.

In the JAX package a 1-D device mesh shards every feed stream on its batch
axis and replicates the state; XLA's SPMD partitioner then computes the
one-device program on the global batch. Here each rank is a process with
one device (``cuda:<rank>`` over NCCL, or the CPU over gloo) and the same
function of the global batch is assembled by hand:

- every rank builds the same state from the seed (``check_replicas``
  holds rank 0's against every rank's) and runs the same feeder from the
  same seed, keeping rows ``[r*b, (r+1)*b)`` of every stream
  (:func:`shard_rows`, what ``NamedSharding(P('data'))`` does);
- every ratio of batch sums in the losses and every BatchNorm statistic is
  taken over the global batch, with one of two reductions;
- the parameter gradients are summed over the ranks, once a step
  (:func:`all_reduce_grads`), before the optimizer step.

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

**Where collectives are issued.** All from the training thread, in
program order: the step's (also inside the CUDA graphs of
``train.graphs``, which capture them on the capture stream) and the
evaluators' (validation runs inline at the eval boundary under a world,
``train.trainer``). One process group then serves every collective, and
two ranks can never issue the same collectives in different orders.

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


@dataclass
class World:
    rank: int
    size: int
    device: torch.device


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
                  init_method: Optional[str] = None) -> Iterator[World]:
    """Join (and on exit leave) a world of ``size`` ranks as ``rank_`` on
    ``device``: NCCL for a card (``cuda:<rank>`` unless an index is
    given), gloo for the CPU, nothing chosen silently. A collective that
    waits longer than TIMEOUT for the other ranks raises. ``init_method``
    defaults to a file store in a fresh temporary directory, which only a
    world of one can share."""
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
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank_,
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
def shard_rows(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Rank r's rows ``[r*b, (r+1)*b)`` of a global stream along ``axis``
    (1 for a K-stacked batch), a view; the whole tensor outside a world."""
    if _WORLD is None:
        return t
    n = t.shape[axis]
    if n % _WORLD.size:
        raise ValueError(f"{n} rows do not split over {_WORLD.size} ranks")
    b = n // _WORLD.size
    return t.narrow(axis, _WORLD.rank * b, b)


def rank_rows(t: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """This rank's rows of ``t``, drawn for the global concat batch of
    ``groups`` sub-batches: global row layout (group, rank, row), so rank
    r keeps ``t.view(groups, N, -1, ...)[:, r]``. What a one-device run
    draws for the global batch, each rank keeps for its own rows."""
    if _WORLD is None:
        return t
    W = _WORLD.size
    rest = t.shape[1:]
    g = t.reshape(groups, W, t.shape[0] // (groups * W), *rest)
    return g[:, _WORLD.rank].reshape(-1, *rest)


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
