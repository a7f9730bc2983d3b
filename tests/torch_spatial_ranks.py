"""What the spatial-partitioning tests run on each rank: functions of numpy
inputs (the global batch, whole volumes) that run the same way in a world
split into data and space indices (``parallel.mesh.set_space``; each rank
takes its rows and its x slab) and outside one (the one-process run on the
global batch the ranks are held against).

This module imports neither jax nor the JAX package: the spawned ranks
import it, and only the test files compare with the JAX package.
"""

import copy

import numpy as np
import torch
import torch.distributed as dist

from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.models import UNet2D, VNet3D, VNetPancreas, create_model
from bcp_tpu_torch.models.layers import (ConvTransposeSame3d, Dropout,
                                         InstanceNorm, SpaceLevels)
from bcp_tpu_torch.models.vnet3d import DOWNS
from bcp_tpu_torch.ops import losses
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train.graphs import DispatchGroups
from bcp_tpu_torch.train.state import TrainState, build_optimizer, init_state
from bcp_tpu_torch.train.steps import (clean_masks, pretrain_step,
                                       selftrain_step)
from bcp_tpu_torch.train.trainer import (copy_paste_box, copy_paste_mask,
                                         iteration_draws)

from torch_parallel_ranks import CONFIGS, _np, _state_out


def run_tasks(tasks):
    """{name: [each rank's result]} of ``tasks`` ({name: (function name,
    space ranks, args)}), run in order, each under its space split;
    outside a world one result each."""
    out = {}
    for name, (fn, sp, args) in tasks.items():
        mesh.set_space(sp if mesh.active() else 1)
        res = globals()[fn](*args)
        if mesh.active():
            parts = [None] * mesh.world_size()
            dist.all_gather_object(parts, res)
            out[name] = parts
        else:
            out[name] = [res]
    return out


class _Slab(torch.autograd.Function):
    """This rank's x slab of a whole tensor every rank holds; its backward
    gathers the slabs' gradients, so each rank's gradient is the whole
    one (what ``gradcheck`` perturbs on every rank at once)."""

    @staticmethod
    def forward(ctx, x):
        return mesh.shard_space(x, 2).clone()

    @staticmethod
    def backward(ctx, g):
        return mesh.gather_space(g, 2)


def local(t, x_axis):
    """This rank's rows and x slab of a global tensor (numpy or torch)."""
    t = torch.as_tensor(t)
    return mesh.shard_space(mesh.shard_rows(t), x_axis)


def local_batch(batch):
    """This rank's part of a global port-layout batch: images (N, 1, X,
    ...) and labels (N, X, ...)."""
    return {k: local(v, 1 if k.startswith("lab") else 2)
            for k, v in batch.items()}


# ---------------- the collectives, with gradcheck ----------------
def collectives(x):
    """On this rank's slab of the whole f64 volume ``x`` (B, C, X, Y, Z):
    the halo'd slab, the gathered volume and the space sum of the slab's
    sums, each with ``torch.autograd.gradcheck`` of L(x) = the world sum
    of <w_r, f(slab_r(x))>, w_r a fixed draw of rank r's (every rank's L:
    the numerical derivative
    sees the neighbours' terms through the world sum, the analytical one
    through the backward's collectives; every rank perturbs the same
    element of its copy at once, so each takes the whole gradient,
    :class:`_Slab`)."""
    xt = torch.from_numpy(x)
    fns = {"halo": mesh.halo, "gather": mesh.gather_space,
           "sum": lambda s: mesh.sum_space(s.sum((2, 3, 4)))}

    def world_loss(f):
        def loss(v):
            y = f(_Slab.apply(v))
            w = np.random.default_rng(mesh.rank()).normal(size=y.shape)
            return mesh.sum_ranks((y * torch.from_numpy(w)).sum())
        return loss

    out = {k: _np(f(local(xt, 2))) for k, f in fns.items()}
    for k, f in fns.items():
        out[f"{k}_gradcheck"] = torch.autograd.gradcheck(
            world_loss(f), (xt.clone().requires_grad_(),),
            raise_exception=False)
    return out


# ---------------- the models ----------------
def _model(kind, nf):
    if kind == "acdc":
        return UNet2D(feature_chns=tuple(nf * 2 ** i for i in range(5)),
                      dropout=(0.0,) * 5)
    if kind == "pancreas":
        return VNetPancreas(n_filters=nf)
    return VNet3D(n_classes=2, n_filters=nf)


def forward(kind, sd, x, w):
    """A train-mode forward of ``kind`` (``sd`` its f64 state_dict) on this
    rank's part of ``x``, the loss the world sum of <w, logits> and its
    backward: (logits, loss, summed parameter gradients, this rank's part
    of dL/dx, running statistics, the last sliced level)."""
    model = _model(kind, 4).double()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = model(local(xt, 2))[0]
    loss = mesh.sum_ranks((y * local(w, 2)).sum())
    loss.backward()
    mesh.all_reduce_grads(model.parameters())
    first = SpaceLevels(local(xt, 2).shape[2], DOWNS if kind != "acdc"
                        else 4).first
    return (_np(y), loss.item(),
            {k: _np(p.grad) for k, p in model.named_parameters()},
            _np(local(xt.grad, 2)),
            {k: _np(v) for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}, first)


def instance_norm(x, w):
    """Instance norm on this rank's part of ``x`` (N, C, X, Y, Z): (y,
    this rank's dL/dx), L the world sum of <w, y>."""
    xt = torch.from_numpy(x).requires_grad_()
    y = InstanceNorm()(local(xt, 2))
    mesh.sum_ranks((y * local(w, 2)).sum()).backward()
    return _np(y), _np(local(xt.grad, 2))


def loss_parts(logits, target, mask, n_classes):
    """Each loss of ``ops.losses`` on this rank's part, and the gradient
    of their weighted sum: ({name: value}, this rank's dL/dlogits)."""
    lt = torch.from_numpy(logits).requires_grad_()
    lo = local(lt, 2)
    t, m = local(target, 1), local(mask, 1)
    parts = {
        "dice_per_class": losses.dice_loss_per_class(
            torch.softmax(lo, 1), t, n_classes, m),
        "masked_ce": losses.masked_cross_entropy(lo, t, m),
        "masked_dice": losses.masked_dice_loss(lo, t, m),
        "ce_mean": losses.cross_entropy_mean(lo, t),
    }
    total = sum((i + 1.0) * v for i, v in enumerate(parts.values()))
    total.backward()
    return ({k: v.item() for k, v in parts.items()},
            _np(local(lt.grad, 2)))


def nms(masks, variant):
    """``steps.clean_masks`` of this rank's part of ``masks`` (N, X, ...)
    with the variant's rule and connectivity."""
    cfg = CONFIGS[variant]()
    return _np(clean_masks(local(masks, 1), cfg))


# ---------------- one update of each pipeline ----------------
def step(variant, stage, start, batch, mask, cfg_kw):
    """One f64 update of ``variant`` from the state_dict ``start`` on this
    rank's part of the global ``batch`` (port layout, numpy) with the whole
    ``mask``, dropout off: (metrics, student, teacher, optimizer state)."""
    cfg = CONFIGS[variant](**cfg_kw)
    model = _model(variant, cfg.n_filters).double()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()},
                          strict=True)
    model.train()
    teacher = copy.deepcopy(model)
    state = TrainState(model, teacher, build_optimizer(cfg,
                                                       model.parameters()))
    mask = torch.from_numpy(mask)
    if stage == "pre":
        metrics = pretrain_step(state, local_batch(batch), mask, cfg)
    else:
        metrics = selftrain_step(state, local_batch(batch), mask, cfg)
    return ({k: v.item() for k, v in metrics.items()}, *_state_out(state))


def remat_steps(variant, batches, remat):
    """Two self-train updates of ``variant`` from the seeded f64 state,
    dropout drawn by the trainer's per-iteration generator, with every
    V-Net block rematerialised or not: (losses, student, teacher,
    optimizer state)."""
    cfg = CONFIGS[variant](**dict(_TINY[variant], remat=remat))
    state = init_state(cfg, "cpu")
    state.model.double()
    state.teacher.double()
    state.optimizer = build_optimizer(cfg, state.model.parameters())
    gen = torch.Generator()
    got = []
    for it, b in enumerate(batches, start=1):
        mask = copy_paste_mask(cfg, iteration_draws(cfg.seed + 1, it, gen))
        m = selftrain_step(state, local_batch(b), mask, cfg, gen, gen)
        got.append({k: v.item() for k, v in m.items()})
    return (got, *_state_out(state))


_TINY = {
    "la": dict(labelnum=4, n_filters=4, patch_size=(16, 16, 16),
               compute_dtype="float32"),
    "pancreas": dict(n_filters=4, patch_size=(16, 16, 16), mask_patch=8,
                     compute_dtype="float32"),
}


def dispatch(cfg_kw, batches, K):
    """Four LA self-train iterations from the seeded f64 state, dropout on
    (the trainer's per-iteration draws), on this rank's part of each
    global batch: K = 1 eager steps, or groups of K through ``GraphStep``'s
    bodies on static buffers (what the card's graphs capture). (losses,
    student, teacher, optimizer state)."""
    cfg = la_config(**cfg_kw)
    state = init_state(cfg, "cpu")
    state.model.double()
    state.teacher.double()
    state.optimizer = build_optimizer(cfg, state.model.parameters())
    gen = torch.Generator()
    seed = cfg.seed + 1
    parts = [local_batch(b) for b in batches]
    got = []
    if K == 1:
        for it, b in enumerate(parts, start=1):
            mask = copy_paste_mask(cfg, iteration_draws(seed, it, gen))
            m = selftrain_step(state, b, mask, cfg, gen, gen)
            got.append({k: v.item() for k, v in m.items()})
    else:
        def draws(it):
            return copy_paste_box(cfg, iteration_draws(seed, it, gen)), gen
        groups = DispatchGroups(state, cfg, "self", K, draws, static=True)
        for g in range(len(parts) // K):
            stacked = {k: torch.stack([b[k] for b in parts[g * K:g * K + K]])
                       for k in parts[0]}
            names, values = groups.run(stacked, g * K + 1)
            got += [dict(zip(names, row)) for row in values.tolist()]
        groups.close()
    return (got, *_state_out(state))


def blob_batch(variant, rows, patch, seed):
    """A global port-layout batch of ``rows`` rows a stream: noisy images
    of balls' labels (classes 1-3 for ACDC), so the teacher's pseudo-labels
    have components."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s) for s in patch],
                             indexing="ij"))
    lo, hi = 0.25 * patch[0], 0.75 * patch[0]
    out = {}
    for k in ("a", "b", "ua", "ub"):
        lab = np.zeros((rows, *patch), np.uint8)
        for c in range(1, 4 if variant == "acdc" else 2):
            ctr = rng.uniform(lo, hi, (rows, len(patch)) + (1,) * len(patch))
            lab[((g[None] - ctr) ** 2).sum(1) <= rng.uniform(
                patch[0], 2.5 * patch[0])] = c
        img = rng.normal(0, 0.3, (rows, 1, *patch)) + 0.5 * lab[:, None]
        if k.startswith("u"):
            out[f"uimg_{k[1]}"] = img
        else:
            out[f"img_{k}"], out[f"lab_{k}"] = img, lab
    return out


# ---------------- what the test files share ----------------
P3 = (16, 16, 16)
P2 = (32, 32)
#: per-data-index configs: the reference batch (2 + 2 labelled, 2 + 2
#: unlabelled)
TINY = {
    "la": dict(labelnum=4, n_filters=4, patch_size=P3, batch_size=8,
               labeled_bs=4, compute_dtype="float32"),
    "acdc": dict(labelnum=1, n_filters=4, patch_size=P2, batch_size=8,
                 labeled_bs=4, compute_dtype="float32"),
    "pancreas": dict(n_filters=4, patch_size=P3, mask_patch=8,
                     batch_size=8, labeled_bs=4, compute_dtype="float32"),
}


def state_dict(kind, seed=0):
    """A seeded f64 state_dict of ``kind``'s net, numpy."""
    torch.manual_seed(seed)
    return {k: v.numpy() for k, v in
            _model(kind, 4).double().state_dict().items()}


def box_mask(variant, seed):
    """A copy-paste mask of the variant's tiny patch: a random box of
    zeros."""
    rng = np.random.default_rng(seed)
    S = TINY[variant]["patch_size"]
    m = np.ones(S, np.int32)
    lo = [int(rng.integers(0, s // 2)) for s in S]
    m[tuple(slice(a, a + s // 2) for a, s in zip(lo, S))] = 0
    return m


def step_task(case, W, sp, seed):
    """The ``step`` task of ``case`` ("la_pre", ...) for a world of W ranks
    in W/sp data indices."""
    variant, stage = case.split("_")
    D = W // sp
    batch = blob_batch(variant, 2 * D, TINY[variant]["patch_size"], seed)
    if stage == "pre":
        batch = {k: v for k, v in batch.items() if not k.startswith("u")}
    kw = dict(TINY[variant], batch_size=8 * D, labeled_bs=4 * D)
    return ("step", sp, (variant, stage, state_dict(variant, 1), batch,
                         box_mask(variant, seed), kw))


def part(a, r, W, sp, x_axis):
    """Rank r's rows and slab of the global array ``a`` (W ranks, W/sp data
    indices)."""
    d, s = divmod(r, sp)
    b, xs = a.shape[0] // (W // sp), a.shape[x_axis] // sp
    return np.take(a[d * b:(d + 1) * b], range(s * xs, (s + 1) * xs),
                   axis=x_axis)


def close(got, want, what, rel=1e-10, floor=1e-12):
    """|got - want| within ``rel`` of want's largest magnitude, or
    ``floor``."""
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= max(rel * scale, floor), f"{what}: err {err} scale {scale}"


def hold(got, want, start, rel=1e-10, floor=1e-12, counts=True):
    """Student / teacher state_dicts: updates as deltas, running statistics
    as values, ``num_batches_tracked`` equal (``counts``)."""
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert not counts or int(v) == int(want[k]), k
        elif k.endswith(("running_mean", "running_var")):
            close(v, want[k], k, rel, floor)
        else:
            close(v - start[k], want[k] - start[k], k, rel, floor)


def same(a, b):
    """Two step results bit for bit: losses, student, teacher, optimizer."""
    assert a[0] == b[0]
    for i in (1, 2, 3):
        assert sorted(a[i]) == sorted(b[i])
        for k, v in a[i].items():
            np.testing.assert_array_equal(v, b[i][k], err_msg=k)


def trainer_checks():
    """This world's trainer at ``sp_devices`` 2: (its data_scale, the
    refusal of a patch whose x extent 15 the split cannot divide)."""
    from bcp_tpu_torch.train.trainer import BCPTrainer
    cfg = la_config(labelnum=4, patch_size=P3, n_filters=4,
                    num_devices=mesh.world_size(), sp_devices=2)
    scale = BCPTrainer(cfg, device="cpu", val_cases=[]).data_scale
    try:
        BCPTrainer(cfg.replace(patch_size=(15, 16, 16)), device="cpu",
                   val_cases=[])
    except ValueError as e:
        return scale, str(e)
    return scale, None


def snapshot_panels(root, train, val, sp, net="VNet", kw=None):
    """The image panels of a tiny LA trainer of ``net`` (a zoo net's
    factory kwargs ``kw``) with ``log_images`` (no pre-train iteration,
    two self-train ones, f32; self-train iteration 1's panels are due) in
    this world at ``sp_devices`` = sp, or in one process: [(stage,
    iteration, {panel: array})], rank 0's (None on the others)."""
    from bcp_tpu_torch.data.datasets import VolumeList
    from bcp_tpu_torch.train import state as port_state
    from bcp_tpu_torch.train.trainer import BCPTrainer
    make = _zoo_widths(kw) if kw is not None else port_state.create_model
    try:
        cfg = la_config(labelnum=4, patch_size=P3, n_filters=4,
                        eval_every=2, eval_batch=2, compute_dtype="float32",
                        snapshot_root=root, pre_iterations=0,
                        self_iterations=2, device_data_cache=False,
                        num_devices=mesh.world_size(), sp_devices=sp,
                        net_type=net)
        panels = []
        trainer = BCPTrainer(cfg, device="cpu",
                             train_dataset=VolumeList(train),
                             val_cases=val, log_images=True)
        trainer._emit_snapshot = lambda writer, stage, feeder, it, p: \
            panels.append((stage, it, {k: _np(v) for k, v in p.items()}))
        trainer.pretrain()
        trainer.selftrain()
    finally:
        port_state.create_model = make
    return panels if mesh.is_main() else None


# ---------------- the model zoo under a split ----------------
def zoo_net(name, kw, classes, start):
    """Zoo net ``name`` (factory kwargs ``kw``) in train mode, f64, from
    the state_dict ``start`` (numpy)."""
    model = create_model(name, classes, mode="train", device="cpu",
                         **kw).double()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()},
                          strict=True)
    return model


def local_keeps(model, keeps, shape):
    """The whole keep masks ``keeps`` (one a dropout, module order) as
    ``model``'s dropouts take them in a forward of this rank's input of
    ``shape``: the slab of those that run on slabs. A forward of a copy
    on zeros says which do."""
    if keeps is None:
        return None
    probe = copy.deepcopy(model)
    with torch.no_grad():
        probe(torch.zeros(shape, dtype=torch.float64))
    axes = [m.slab_axis() for m in probe.modules() if isinstance(m, Dropout)]
    return [torch.from_numpy(k) if a is None
            else mesh.shard_space(torch.from_numpy(k), a)
            for k, a in zip(keeps, axes)]


def zoo_update(name, kw, variant, stage, start, batch, mask, keeps,
               cfg_kw):
    """One f64 update of zoo net ``name`` (factory kwargs ``kw``) through
    the ``variant`` steps from ``start`` on this rank's part of the global
    ``batch`` (port layout) with the whole ``mask``; every dropout takes
    the whole keep masks of ``keeps`` ({"pre": [...]} or {"teacher": ...,
    "student": ...}, :func:`local_keeps`). (metrics, student, teacher,
    optimizer state, the whole pseudo-labels of the self-train step)."""
    cfg = CONFIGS[variant](**cfg_kw).replace(net_type=name)
    model = zoo_net(name, kw, cfg.num_classes, start)
    teacher = copy.deepcopy(model)
    for p in teacher.parameters():
        p.requires_grad_(False)
    state = TrainState(model, teacher, build_optimizer(cfg,
                                                       model.parameters()))
    b = local_batch(batch)
    mask = torch.from_numpy(mask)
    rows = tuple(b["img_a"].shape)
    plab = []
    if stage == "pre":
        metrics = pretrain_step(state, b, mask, cfg, dropout=local_keeps(
            model, keeps["pre"], rows))
    else:
        cat = (2 * rows[0],) + rows[1:]
        metrics = selftrain_step(
            state, b, mask, cfg, local_keeps(model, keeps["teacher"], cat),
            local_keeps(model, keeps["student"], cat),
            lambda p: plab.append(_np(mesh.gather_space(p, 1))))
    return ({k: v.item() for k, v in metrics.items()}, *_state_out(state),
            plab[0] if plab else None)


def transpose_slabs(sd, x, w):
    """``ConvTransposeSame3d`` (f64, the state_dict ``sd``) on this rank's
    x slab of ``x``, L the world sum of <w, y> and its backward: (this
    rank's y, its dL/dx, the summed weight and bias gradients)."""
    conv = ConvTransposeSame3d(x.shape[1], w.shape[1]).double()
    conv.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    xt = torch.from_numpy(x).requires_grad_()
    y = conv(local(xt, 2))
    mesh.sum_ranks((y * local(w, 2)).sum()).backward()
    mesh.all_reduce_grads(conv.parameters())
    return (_np(y), _np(local(xt.grad, 2)),
            {k: _np(p.grad) for k, p in conv.named_parameters()})


def zoo_dispatch(name, kw, cfg_kw, batches, K):
    """Four LA self-train iterations of zoo net ``name`` (factory kwargs
    ``kw``) from its seeded f64 state, dropout on (the trainer's
    per-iteration draws), on this rank's part of each global batch: K = 1
    eager steps or groups of K on static buffers (:func:`dispatch`)."""
    from bcp_tpu_torch.train import state as port_state
    make = _zoo_widths(kw)
    try:
        return dispatch(dict(cfg_kw, net_type=name), batches, K)
    finally:
        port_state.create_model = make


def _zoo_widths(kw):
    """Wrap the trainer's ``create_model`` to the factory kwargs ``kw``
    (the config's ``n_filters`` dropped); returns the unwrapped one."""
    from bcp_tpu_torch.train import state as port_state
    make = port_state.create_model
    port_state.create_model = lambda t, *a, **k: make(t, *a, **{
        **kw, **{n: v for n, v in k.items() if n != "n_filters"}})
    return make


def zoo_trainer_checks(root, nets):
    """In this world at ``sp_devices`` 2, for each zoo net of ``nets``
    ({net type: (factory kwargs, patch)}): (the trainer's data_scale,
    the space ranks it set)."""
    from bcp_tpu_torch.config import acdc_config
    from bcp_tpu_torch.train import state as port_state
    from bcp_tpu_torch.train.trainer import BCPTrainer
    out = {}
    for name, (kw, patch) in nets.items():
        make = _zoo_widths(kw)
        try:
            base = la_config(labelnum=4) if len(patch) == 3 else \
                acdc_config(labelnum=1)
            cfg = base.replace(patch_size=patch, net_type=name,
                               num_devices=mesh.world_size(), sp_devices=2,
                               compute_dtype="float32", snapshot_root=root)
            out[name] = (BCPTrainer(cfg, device="cpu", val_cases=[])
                         .data_scale, mesh.space_size())
        finally:
            port_state.create_model = make
    return out


def zoo_cli(root, name, kw, train, val):
    """``train_la --model name --num_devices 2 --sp_devices 2 --device
    cpu``'s core in this world of two ranks (two iterations a stage,
    factory kwargs ``kw``): rank 0's {stage: (best dice, best .pth)}."""
    from bcp_tpu_torch.cli import train_la
    from bcp_tpu_torch.data.datasets import VolumeList
    from bcp_tpu_torch.train import state as port_state
    make = _zoo_widths(kw)
    try:
        args = train_la.build_parser().parse_args(
            ["--labelnum", "4", "--pre_max_iteration", "2",
             "--self_max_iteration", "2", "--snapshot_root", root,
             "--model", name, "--device", "cpu", "--num_devices", "2",
             "--sp_devices", "2"])
        trainer, out = train_la.train(
            args, train_dataset=VolumeList(train), val_cases=val,
            patch_size=P3, eval_every=2, eval_batch=2,
            compute_dtype="float32")
    finally:
        port_state.create_model = make
    return (trainer.data_scale, out) if mesh.is_main() else None

