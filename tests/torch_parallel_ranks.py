"""What the data-parallel tests run on each rank: functions of numpy inputs
(the global batch) that run the same way in a world of several ranks
(``parallel.mesh``; each rank takes its rows) and outside one (the
one-process run on the global batch the ranks are held against).

This module imports neither jax nor the JAX package: the spawned ranks
import it, and only the test files compare with the JAX package.
"""

import copy

import torch
import torch.distributed as dist

from bcp_tpu_torch.config import acdc_config, la_config, pancreas_config
from bcp_tpu_torch.eval.slice2d import Slice2DEvaluator
from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator
from bcp_tpu_torch.models import UNet2D, VNet3D, VNetPancreas, create_model
from bcp_tpu_torch.models.layers import TorchBatchNorm
from bcp_tpu_torch.ops import losses
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train.graphs import DispatchGroups
from bcp_tpu_torch.train.state import TrainState, build_optimizer, init_state
from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
from bcp_tpu_torch.train.trainer import (copy_paste_box, copy_paste_mask,
                                         iteration_draws)

CONFIGS = {"la": la_config, "acdc": acdc_config, "pancreas": pancreas_config}


def run_tasks(tasks):
    """{name: [each rank's result]} of ``tasks`` ({name: (function name,
    args)}), run in order; outside a world one result each."""
    out = {}
    for name, (fn, args) in tasks.items():
        res = globals()[fn](*args)
        if mesh.active():
            parts = [None] * mesh.world_size()
            dist.all_gather_object(parts, res)
            out[name] = parts
        else:
            out[name] = [res]
    return out


def _np(t):
    return t.detach().cpu().numpy().copy()


# ---------------- the two reductions on a toy function ----------------
def toy(x):
    """L = sum_r(sum x^3) * sum_r(sum (x - mean)^2), the mean a BatchNorm-
    like statistic over the global rows: (L, this rank's rows of dL/dx)."""
    xt = torch.from_numpy(x).requires_grad_()
    local = mesh.shard_rows(xt)
    s1 = mesh.sum_ranks((local ** 3).sum())
    m = mesh.mean_statistics(local.mean(0))
    s2 = mesh.sum_ranks(((local - m) ** 2).sum())
    loss = s1 * s2 + mesh.mean_ranks(local.mean())
    loss.backward()
    return loss.item(), _np(mesh.shard_rows(xt.grad))


# ---------------- grouped BatchNorm ----------------
def batchnorm(x, w, groups):
    """A 2-group train-mode ``TorchBatchNorm`` on this rank's rows of the
    global concat batch ``x``, the loss sum(y * w) over the ranks:
    (y, dL/dx, running mean and var, num_batches_tracked, dL/dweight,
    dL/dbias)."""
    torch.manual_seed(0)
    bn = TorchBatchNorm(x.shape[1], groups=groups).double()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(mesh.rank_rows(xt, groups))
    wl = mesh.rank_rows(torch.from_numpy(w), groups)
    loss = mesh.sum_ranks((y * wl).sum())
    loss.backward()
    mesh.all_reduce_grads(bn.parameters())
    return (_np(y), _np(mesh.rank_rows(xt.grad, groups)),
            _np(bn.running_mean), _np(bn.running_var),
            int(bn.num_batches_tracked), _np(bn.weight.grad),
            _np(bn.bias.grad))


# ---------------- the losses ----------------
def loss_parts(logits, target, mask, n_classes):
    """Each loss of ``ops.losses`` on this rank's rows, and the gradient
    of their weighted sum: ({name: value}, dL/dlogits rows)."""
    lt = torch.from_numpy(logits).requires_grad_()
    local = mesh.shard_rows(lt)
    t = mesh.shard_rows(torch.from_numpy(target))
    m = mesh.shard_rows(torch.from_numpy(mask))
    parts = {
        "dice_per_class": losses.dice_loss_per_class(
            torch.softmax(local, 1), t, n_classes, m),
        "masked_ce": losses.masked_cross_entropy(local, t, m),
        "masked_dice": losses.masked_dice_loss(local, t, m),
        "ce_mean": losses.cross_entropy_mean(local, t),
    }
    total = sum((i + 1.0) * v for i, v in enumerate(parts.values()))
    total.backward()
    return ({k: v.item() for k, v in parts.items()},
            _np(mesh.shard_rows(lt.grad)))


# ---------------- one update of each pipeline ----------------
def _model(variant, nf):
    if variant == "acdc":
        return UNet2D(feature_chns=tuple(nf * 2 ** i for i in range(5)),
                      dropout=(0.0,) * 5)
    if variant == "pancreas":
        return VNetPancreas(n_filters=nf)
    return VNet3D(n_classes=2, n_filters=nf)


def _state_out(state):
    """(student, teacher, optimizer state by parameter name), numpy."""
    opt = {}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.state.get(p, {}).items():
            if isinstance(v, torch.Tensor):
                opt[f"{name}.{k}"] = _np(v)
    return ({k: _np(v) for k, v in state.model.state_dict().items()},
            {k: _np(v) for k, v in state.teacher.state_dict().items()}, opt)


def step(variant, stage, start, batch, mask, cfg_kw):
    """One f64 update of ``variant`` from the state_dict ``start`` on this
    rank's rows of the global ``batch`` (port layout, numpy) with the mask
    ``mask``, dropout off: (metrics, student, teacher, optimizer state)."""
    cfg = CONFIGS[variant](**cfg_kw)
    model = _model(variant, cfg.n_filters).double()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()},
                          strict=True)
    model.train()
    teacher = copy.deepcopy(model)
    state = TrainState(model, teacher, build_optimizer(cfg,
                                                       model.parameters()))
    local = {k: mesh.shard_rows(torch.from_numpy(v))
             for k, v in batch.items()}
    mask = torch.from_numpy(mask)
    if stage == "pre":
        metrics = pretrain_step(state, local, mask, cfg)
    else:
        metrics = selftrain_step(state, local, mask, cfg)
    return ({k: v.item() for k, v in metrics.items()}, *_state_out(state))


def zoo_step(net_type, kw, stage, start, batch, mask, cfg_kw, seed):
    """One f64 LA update of the zoo net ``net_type`` (factory kwargs
    ``kw``) from the state_dict ``start`` on this rank's rows of the global
    ``batch``, dropout on: every forward draws from one generator seeded
    ``seed``, over the global batch (this rank keeps its rows). (metrics,
    student, teacher, optimizer state)."""
    cfg = la_config(**cfg_kw).replace(net_type=net_type)
    model = create_model(net_type, 2, mode="train", device="cpu",
                         **kw).double()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()},
                          strict=True)
    teacher = copy.deepcopy(model)
    for p in teacher.parameters():
        p.requires_grad_(False)
    state = TrainState(model, teacher, build_optimizer(cfg,
                                                       model.parameters()))
    local = {k: mesh.shard_rows(torch.from_numpy(v))
             for k, v in batch.items()}
    gen = torch.Generator().manual_seed(seed)
    mask = torch.from_numpy(mask)
    if stage == "pre":
        metrics = pretrain_step(state, local, mask, cfg, gen)
    else:
        metrics = selftrain_step(state, local, mask, cfg, gen, gen)
    return ({k: v.item() for k, v in metrics.items()}, *_state_out(state))


# ---------------- K = 2 against K = 1 ----------------
def dispatch(cfg_kw, batches, K):
    """Four LA self-train iterations from the seeded f64 state, dropout on
    (the trainer's per-iteration draws), on this rank's rows of each global
    batch: K = 1 eager steps, or groups of K through ``GraphStep``'s
    bodies on static buffers (what the card's graphs capture). (losses,
    student, teacher, optimizer state)."""
    cfg = la_config(**cfg_kw)
    state = init_state(cfg, "cpu")
    state.model.double()
    state.teacher.double()
    state.optimizer = build_optimizer(cfg, state.model.parameters())
    gen = torch.Generator()
    seed = cfg.seed + 1
    local = [{k: mesh.shard_rows(torch.from_numpy(v)) for k, v in b.items()}
             for b in batches]
    got = []
    if K == 1:
        for it, b in enumerate(local, start=1):
            mask = copy_paste_mask(cfg, iteration_draws(seed, it, gen))
            m = selftrain_step(state, b, mask, cfg, gen, gen)
            got.append({k: v.item() for k, v in m.items()})
    else:
        def draws(it):
            return copy_paste_box(cfg, iteration_draws(seed, it, gen)), gen
        groups = DispatchGroups(state, cfg, "self", K, draws, static=True)
        for g in range(len(local) // K):
            stacked = {k: torch.stack([b[k] for b in local[g * K:g * K + K]])
                       for k in local[0]}
            names, values = groups.run(stacked, g * K + 1)
            got += [dict(zip(names, row)) for row in values.tolist()]
        groups.close()
    return (got, *_state_out(state))


# ---------------- the evaluators ----------------
def sliding_window(weights, image, nf, patch, strides, batch):
    """(label, score) of the V-Net's sliding-window inference of
    ``image``, each rank forwarding its windows of every chunk."""
    model = VNet3D(n_classes=2, n_filters=nf)
    model.load_state_dict(weights, strict=True)
    ev = SlidingWindowEvaluator(model.eval(), patch, 2, *strides,
                                batch=batch, device="cpu")
    label, score = ev.infer(image)
    return label, score


def slices(weights, volume, nf, patch):
    """The U-Net's per-slice labels of ``volume``, each rank forwarding
    its block of slices."""
    model = UNet2D(feature_chns=tuple(nf * 2 ** i for i in range(5)),
                   dropout=(0.0,) * 5)
    model.load_state_dict(weights, strict=True)
    return Slice2DEvaluator(model.eval(), patch, 4,
                            device="cpu").predict_volume(volume)


# ---------------- the CLIs inside a world ----------------
def _tiny_pancreas(cfg_fn, patch):
    def wrapped(*a, **k):
        return cfg_fn(*a, **k).replace(patch_size=patch, n_filters=4,
                                       eval_batch=2,
                                       compute_dtype="float32")
    return wrapped


def cli_runs(root, la_pth, la_test, acdc, panc):
    """The CLIs' cores with ``--num_devices 2 --device cpu`` in this world
    (in-process: the world exists): ``test_la`` from ``la_pth`` on
    ``la_test``; ``train_acdc`` then ``test_acdc`` from its best file on
    ``acdc`` = (slices, volumes); ``train_pancreas`` then ``test_pancreas``
    on ``panc`` = (lab, unlab, test) cases. Rank 0 returns
    {cli: its result}; the other ranks' test CLIs return None."""
    import os
    from bcp_tpu_torch.cli import (test_acdc, test_la, test_pancreas,
                                   train_acdc, train_pancreas)
    from bcp_tpu_torch.data import feed
    from bcp_tpu_torch.data.datasets import (PancreasList, SliceList,
                                             VolumeList)
    two = ["--num_devices", "2", "--device", "cpu"]
    out = {"test_la": test_la.test_calculate_metric(
        test_la.build_parser().parse_args(la_test_flags(root, la_pth) + two),
        dataset=VolumeList(la_test))}
    feed.ACDC_PATIENTS_TO_SLICES[1] = 8
    slices, vols = acdc
    acdc_root = os.path.join(root, "acdc")
    _, out["train_acdc"] = train_acdc.train(
        train_acdc.build_parser().parse_args(
            ["--labelnum", "1", "--pre_iterations", "2", "--max_iterations",
             "2", "--batch_size", "8", "--labeled_bs", "4",
             "--snapshot_root", acdc_root, *two]),
        train_dataset=SliceList(slices), val_cases=vols,
        patch_size=(32, 32), n_filters=4, eval_every=2,
        compute_dtype="float32")
    out["test_acdc"] = test_acdc.test_calculate_metric(
        test_acdc.build_parser().parse_args(
            acdc_test_flags(acdc_root, out["train_acdc"]["self"][1]) + two),
        dataset=VolumeList(vols))
    lab, unlab, test = panc
    panc_root = os.path.join(root, "pancreas")
    _, out["train_pancreas"] = train_pancreas.train(
        train_pancreas.build_parser().parse_args(
            ["--snapshot_root", panc_root, "--pretraining_epochs", "1",
             "--self_training_epochs", "1", *two]),
        train_dataset=(PancreasList(lab), PancreasList(unlab,
                                                       "train_unlab")),
        val_cases=test, patch_size=(16, 16, 16), n_filters=4, mask_patch=8,
        eval_every=1, eval_batch=2, compute_dtype="float32")
    test_pancreas.pancreas_config = _tiny_pancreas(
        test_pancreas.pancreas_config, (16, 16, 16))
    out["test_pancreas"] = test_pancreas.test_calculate_metric(
        test_pancreas.build_parser().parse_args(
            ["--torch_ckpt", out["train_pancreas"]["self"][1],
             "--snapshot_root", panc_root, *two]),
        dataset=VolumeList(test))
    return out


def la_test_flags(root, pth):
    return ["--root_path", root, "--labelnum", "4", "--snapshot_root", root,
            "--torch_ckpt", pth, "--n_filters", "4", "--patch_size", "16",
            "16", "16", "--stride_xy", "6", "--stride_z", "4",
            "--eval_batch", "2", "--detail", "1", "--nms", "1"]


def acdc_test_flags(root, pth):
    return ["--labelnum", "1", "--snapshot_root", root, "--torch_ckpt", pth,
            "--n_filters", "4", "--patch_size", "32", "32"]
