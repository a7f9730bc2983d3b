"""``--sp_devices`` for the model zoo: each trainable 3-D zoo net's update
over two gloo ranks that split every volume's x extent (``--num_devices 2
--sp_devices 2``: one data index) against the same update in one process
on the whole volumes, and against the JAX package's step on
``make_mesh(2, sp=2)`` of the virtual CPU devices. This file holds
``unet_3D`` and ``unet_3D_dtc`` through the LA steps at 16^3 (``ZOO``'s
narrow widths: slabs of 8, 4, 2, 1, so the bottom level runs replicated),
``ConvTransposeSame3d`` on slabs, UNet3D at K = 2 against K = 1 under the
split, ``train_la --model unet_3D`` through the CLI core, UNet3D's image
snapshots under the split, the pickers at the zoo's halo'd slabs and the
trainer's acceptance;
``test_torch_spatial_zoo_unetr.py`` holds UNETR and UNETR_DTC,
``test_torch_spatial_zoo_2d.py`` the 2-D nets (the files run in
parallel).

Every dropout takes the JAX step's own keep masks
(``test_torch_zoo_steps.jax_keep_masks``), whole on the one process; each
rank keeps the slab of those its dropouts take on slabs
(``torch_spatial_ranks.local_keeps``). Float64 throughout.

- Two ranks against one process: the losses to rtol 1e-10; every update
  (parameters, teacher, momentum) within 1e-10 of the one-process
  update's largest magnitude per tensor (floor 1e-12); the running
  statistics within 1e-10; ``num_batches_tracked`` equal; the
  pseudo-labels equal. For the nets whose heads come out in f32 (UNet3D's
  and UNETR's, as the JAX package casts them) 1e-6 in place of 1e-10:
  their losses are f32 sums, taken slab by slab in another order, and so
  is the loss's gradient (f32 rounding, ~1e-7, reaches every update; a
  wrong plane would move it by 1e-2 or more). The ranks end in the same
  state bit for bit.
- Two ranks against the JAX package's ``sp=2`` step: the tolerances of
  ``test_torch_zoo_steps.py``: losses to rtol 1e-9 (1e-6 for the nets
  whose heads come out in f32), updates within 1e-3 of the JAX update's
  largest magnitude, running statistics to 1e-9, the pseudo-labels equal
  voxel for voxel.

The ranks run in one spawned world for every case of the file."""

import jax
import numpy as np
import pytest
import torch

from bcp_tpu.models import create_model as flax_create
from bcp_tpu.parallel import make_mesh, replicate_state, shard_batch
from bcp_tpu.train.state import build_optimizer as jax_build_optimizer
from bcp_tpu.train.state import init_state as jax_init_state
from bcp_tpu.train.steps import (_pseudo_label, _teacher_forward,
                                 make_pretrain_step, make_selftrain_step)
from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.data.synthetic import la_cases
from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.models.layers import ConvTransposeSame3d
from bcp_tpu_torch.ops.conv3d import (conv_variant, dw_variant,
                                      kernel_takes)
from bcp_tpu_torch.ops.masks import cuboid_mask
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train import state as port_state
from bcp_tpu_torch.train.trainer import BCPTrainer

import torch_spatial_ranks as sr
from test_torch_steps import _f64, _np
from test_torch_train_ops import jax_cuboid_starts
from test_torch_zoo_steps import (F32_HEADS, _configs, _port_masks, _sd,
                                  jax_keep_masks)
from torch_port_helpers import ZOO, _randomised_tree, flax_zoo, zoo_classes

#: case name -> (net type, factory kwargs, patch, ZOO fixture): the
#: narrow UNet3D widths
NETS = {"unet_3D": ("unet_3D", ZOO["unet_3D_narrow"][0], sr.P3,
                    "unet_3D_narrow"),
        "unet_3D_dtc": ("unet_3D_dtc", ZOO["unet_3D_dtc"][0], sr.P3,
                        "unet_3D_dtc")}
KW = {k: v[1] for k, v in NETS.items()}


def cases(names):
    return [f"{n}-{s}" for n in names for s in ("pre", "self")]


def _sdn(name, params, stats):
    """``_sd``'s f64 state_dict as numpy."""
    return {k: v.numpy() for k, v in _sd(name, params, stats).items()}


def _flax(name, kw, patch, seed):
    """(flax model, randomised numpy variables) of zoo net ``name`` with
    factory kwargs ``kw`` at ``patch`` (``flax_zoo``'s, for widths and
    windows ``ZOO`` does not hold)."""
    model = flax_create(name, zoo_classes(name), **kw)
    rngs = {"params": jax.random.PRNGKey(seed),
            "dropout": jax.random.PRNGKey(seed + 1)}
    x = np.zeros((1, *patch, 1), np.float32)
    variables = jax.jit(lambda r, a: model.init(r, a, train=False))(rngs, x)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    return model, _randomised_tree(variables, seed)


def jax_sp_step(name, stage, kw, patch, fixture=None):
    """The JAX package's f64 update of zoo net ``name`` (factory kwargs
    ``kw``) on ``make_mesh(2, sp=2)`` at ``patch``: (start state_dict,
    global port batch, port mask, the whole port keep masks of each
    forward, JAX state after, JAX metrics, JAX pseudo-labels or None).
    ``fixture`` names a ``ZOO`` fixture to take the flax net from."""
    jax.config.update("jax_enable_x64", True)
    try:
        return _jax_sp_step(name, stage, kw, patch, fixture)
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_sp_step(name, stage, kw, patch, fixture):
    jcfg = _configs(name, True).replace(patch_size=patch)
    if fixture is not None:
        fmodel, variables, _ = flax_zoo(fixture, seed=6)
    else:
        fmodel, variables = _flax(name, kw, patch, 6)
    tx = jax_build_optimizer(jcfg, stage)
    st = jax_init_state(fmodel, jcfg, jax.random.PRNGKey(3), tx)
    params = _f64(variables["params"])
    stats = _f64(variables.get("batch_stats", {}))
    st = st.replace(params=params, batch_stats=stats,
                    teacher_params=_f64(params),
                    teacher_batch_stats=_f64(stats),
                    opt_state=tx.init(params))
    start = _sdn(name, params, stats)
    variant = "acdc" if len(patch) == 2 else "la"
    port = sr.blob_batch(variant, 2, patch, 4)
    if stage == "pre":
        port = {k: v for k, v in port.items() if not k.startswith("u")}
    batch = {k: np.moveaxis(v, 1, -1) if k.startswith(("img", "uimg"))
             else v for k, v in port.items()}
    vs = {"params": params, "batch_stats": stats} if stats else \
        {"params": params}
    key = jax.random.PRNGKey(5)
    n = 2
    plab = None
    if stage == "pre":
        mask_key, drop_key = jax.random.split(key)
        fn = make_pretrain_step(fmodel, tx, jcfg)
        keeps = {"pre": jax_keep_masks(fmodel, vs, (n, *patch, 1),
                                       drop_key)}
    else:
        mask_key, tkey, skey = jax.random.split(key, 3)
        fn = make_selftrain_step(fmodel, tx, jcfg)
        keeps = {"teacher": jax_keep_masks(fmodel, vs, (2 * n, *patch, 1),
                                           tkey),
                 "student": jax_keep_masks(fmodel, vs, (2 * n, *patch, 1),
                                           skey)}
        u = np.concatenate([batch["uimg_a"], batch["uimg_b"]])
        plab = np.asarray(_pseudo_label(jcfg, _teacher_forward(
            fmodel, params, stats, u, tkey)))
    keeps = {k: [m.numpy() for m in _port_masks(name, v)]
             for k, v in keeps.items()}
    mask = cuboid_mask(patch, jax_cuboid_starts(mask_key, patch))
    sp = make_mesh(2, sp=2)
    new, metrics = fn(replicate_state(st, sp), shard_batch(batch, sp), key)
    return (start, port, mask.numpy(), keeps, _np(new),
            {k: float(v) for k, v in metrics.items()}, plab)


def update_task(name, stage, kw, want):
    """The ``zoo_update`` task of one case from its JAX run ``want``."""
    start, batch, mask, keeps = want[:4]
    variant = "acdc" if batch["img_a"].ndim == 4 else "la"
    cfg = _configs(name, False)
    cfg_kw = dict(patch_size=tuple(batch["img_a"].shape[2:]),
                  labelnum=cfg.labelnum, batch_size=cfg.batch_size,
                  labeled_bs=cfg.labeled_bs, compute_dtype="float32")
    return ("zoo_update", 2, (name, kw, variant, stage, start, batch, mask,
                              keeps, cfg_kw))


def split_runs(nets, extra=None):
    """(the JAX ``sp=2`` runs, the one process's updates, the two ranks'
    results) of both stages of each of ``nets`` ({case name: (net type,
    factory kwargs, patch, ZOO fixture or None)}), with the world's
    ``extra`` tasks."""
    want, tasks = {}, {}
    for case in cases(nets):
        key, stage = case.split("-")
        name, kw, patch, fixture = nets[key]
        want[case] = jax_sp_step(name, stage, kw, patch, fixture)
        tasks[case] = update_task(name, stage, kw, want[case])
    two = mesh.launch(sr.run_tasks, 2, "cpu", dict(tasks, **(extra or {})))
    one = sr.run_tasks(tasks)
    return want, {c: v[0] for c, v in one.items()}, two


def hold_split(runs, case, name):
    """``case``'s two ranks against each other, one process and the JAX
    ``sp=2`` step (module docstring)."""
    want, one, two = runs
    start, _, _, _, new, jmetrics, jplab = want[case]
    a, b = two[case]
    sr.same(a[:4], b[:4])
    if a[4] is not None:
        np.testing.assert_array_equal(a[4], b[4])
    got, ref = a, one[case]
    # the nets whose heads come out in f32: f32 loss sums and their
    # gradients, taken slab by slab in another order
    rel = 1e-6 if name in F32_HEADS else 1e-10
    for k, v in ref[0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=rel, err_msg=k)
    sr.hold(got[1], ref[1], start, rel)
    sr.hold(got[2], ref[2], start, rel)
    assert sorted(got[3]) == sorted(ref[3]) and got[3]
    for k, v in ref[3].items():
        sr.close(got[3][k], v, k, rel)
    if ref[4] is not None:
        np.testing.assert_array_equal(got[4], ref[4])
        np.testing.assert_array_equal(got[4], jplab)
    rtol = 1e-6 if name in F32_HEADS else 1e-9
    assert set(got[0]) == set(jmetrics)
    for k, v in got[0].items():
        np.testing.assert_allclose(v, jmetrics[k], rtol=rtol, err_msg=k)
    sr.hold(got[1], _sdn(name, new.params, new.batch_stats), start, 1e-3,
            1e-9, counts=False)
    teacher = _sdn(name, new.teacher_params, new.teacher_batch_stats)
    for k, v in got[2].items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            sr.close(v, teacher[k], k, 1e-9, 1e-9)
        else:
            sr.close(v - start[k], teacher[k] - start[k], k, 1e-3, 1e-9)


# ---------------- ConvTransposeSame3d on slabs ----------------
#: (x shape, S): slabs of even and odd extent
TRANSPOSES = [((2, 4, 8, 6, 4), 2), ((2, 4, 6, 6, 4), 2),
              ((2, 4, 8, 6, 4), 4), ((1, 4, 12, 4, 6), 4)]


def _transpose_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    conv = ConvTransposeSame3d(shape[1], 3).double()
    sd = {k: v.numpy() for k, v in conv.state_dict().items()}
    x = rng.normal(size=shape)
    w = rng.normal(size=(shape[0], 3, *(2 * s for s in shape[2:])))
    return sd, x, w


def _transpose_whole(sd, x, w):
    conv = ConvTransposeSame3d(x.shape[1], w.shape[1]).double()
    conv.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    xt = torch.from_numpy(x).requires_grad_()
    y = conv(xt)
    (y * torch.from_numpy(w)).sum().backward()
    return conv, xt, y


#: the train and validation cases of the CLI and snapshot runs
TRAIN = la_cases(8, (20, 20, 18), seed=11)
VAL = la_cases(1, (24, 22, 20), seed=12)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    extra = {f"transpose_{i}": ("transpose_slabs", 2,
                                _transpose_inputs(shape, i))
             for i, (shape, S) in enumerate(TRANSPOSES) if S == 2}
    la = [sr.blob_batch("la", 2, sr.P3, seed=20 + i) for i in range(4)]
    kw = dict(sr.TINY["la"], batch_size=4, labeled_bs=2)
    for K in (1, 2):
        extra[f"k{K}"] = ("zoo_dispatch", 2, ("unet_3D", KW["unet_3D"], kw,
                                              la, K))
    extra["cli"] = ("zoo_cli", 2, (
        str(tmp_path_factory.mktemp("zoo_cli")), "unet_3D", KW["unet_3D"],
        TRAIN, VAL))
    extra["trainer"] = ("zoo_trainer_checks", 2, (
        str(tmp_path_factory.mktemp("zoo_trainer")), ACCEPTED))
    extra["snap"] = ("snapshot_panels", 2, (
        str(tmp_path_factory.mktemp("zoo_snap")), TRAIN, VAL, 2, "unet_3D",
        KW["unet_3D"]))
    return split_runs(NETS, extra)


@pytest.mark.parametrize("case", cases(NETS))
def test_zoo_split_update(runs, case):
    hold_split(runs, case, NETS[case.split("-")[0]][0])


@pytest.mark.parametrize("i", [i for i, (_, S) in enumerate(TRANSPOSES)
                               if S == 2])
def test_transpose_on_two_ranks_is_the_whole_volumes(runs, i):
    """The layer under a split (``mesh.halo`` and the crop of
    ``on_padded_slab``): each rank's output and input gradient are its
    slab of the whole volume's, the summed weight and bias gradients the
    whole's, to 1e-12 of the largest."""
    shape, S = TRANSPOSES[i]
    sd, x, w = _transpose_inputs(shape, i)
    conv, xt, y = _transpose_whole(sd, x, w)
    got = runs[2][f"transpose_{i}"]
    for r, (gy, gdx, gw) in enumerate(got):
        sr.close(gy, sr.part(y.detach().numpy(), r, 2, 2, 2), "y")
        sr.close(gdx, sr.part(xt.grad.numpy(), r, 2, 2, 2), "dx")
        for k, p in conv.named_parameters():
            sr.close(gw[k], p.grad.numpy(), k)


@pytest.mark.parametrize("shape,S", TRANSPOSES)
def test_transpose_on_padded_slabs_is_the_whole_volume(shape, S):
    """``on_padded_slab`` of each of the S halo-padded slabs
    (``mesh.halo_slabs``) concatenated is the whole volume's transposed
    conv, and the gradients through the slabs are the whole's, at S = 2
    and 4, even and odd slab extents."""
    sd, x, w = _transpose_inputs(shape, 7)
    conv, xt, y = _transpose_whole(sd, x, w)
    part = ConvTransposeSame3d(shape[1], 3).double()
    part.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    xs = torch.from_numpy(x).requires_grad_()
    ys = torch.cat([part.on_padded_slab(p)
                    for p in mesh.halo_slabs(xs, S)], 2)
    (ys * torch.from_numpy(w)).sum().backward()
    sr.close(ys.detach().numpy(), y.detach().numpy(), "y")
    sr.close(xs.grad.numpy(), xt.grad.numpy(), "dx")
    for (k, p), q in zip(part.named_parameters(), conv.parameters()):
        sr.close(p.grad.numpy(), q.grad.numpy(), k)


def test_zoo_k2_equals_k1_under_a_space_split(runs):
    """UNet3D, four self-train iterations with its channel dropout on:
    K = 2 (the static-buffer bodies a graph captures) bit for bit K = 1."""
    two = runs[2]
    for a, b in zip(two["k2"], two["k1"]):
        sr.same(a, b)


def test_train_la_unet_3d_on_two_ranks_splitting_each_volume(runs):
    """``train_la --model unet_3D --num_devices 2 --sp_devices 2 --device
    cpu``'s core, 2 + 2 iterations: one data index, both stages' best
    checkpoints loading strictly into the zoo net."""
    scale, out = runs[2]["cli"][0]
    assert scale == 1 and set(out) == {"pre", "self"}
    for stage, (dice, path) in out.items():
        assert 0.0 <= dice <= 1.0
        assert path.endswith(f"{stage}_train/unet_3D_best_model.pth")
        model = create_model("unet_3D", 2, device="cpu", **KW["unet_3D"])
        model.load_state_dict(torch.load(path), strict=True)


def test_zoo_image_snapshots_under_a_split_are_the_whole_volumes(runs,
                                                                tmp_path):
    """UNet3D's ``log_images`` panels at N = S = 2 (self-train iteration 1,
    from the seeded state) equal one process's on the same batch bit for
    bit, as ``test_torch_spatial_cli.py`` holds the V-Net's."""
    got = runs[2]["snap"][0]
    want = sr.snapshot_panels(str(tmp_path), TRAIN, VAL, 1, "unet_3D",
                              KW["unet_3D"])
    assert [(s, i) for s, i, _ in got] == [(s, i) for s, i, _ in want] \
        == [("self", 1)]
    for k, v in want[0][2].items():
        np.testing.assert_array_equal(got[0][2][k], v, err_msg=k)


# ---------------- the trainer ----------------
#: each trainable zoo net's small widths and patch (UNETR at its window)
ACCEPTED = {n: (ZOO["unet_3D_narrow" if n == "unet_3D" else n][0],
                (32, 32) if n in ("unet_2d_bcp", "unet_tsne") else sr.P3)
            for n in ("unet_3D", "unet_3D_dtc", "unetr", "unetr_dtc",
                      "unet_2d_bcp", "unet_tsne")}


def _narrow(monkeypatch, name):
    kw = dict(ZOO[name][0]) if name in ZOO else {}
    make = port_state.create_model
    monkeypatch.setattr(port_state, "create_model", lambda t, *a, **k: make(
        t, *a, **({**kw, **k} if t == name else k)))


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_trainer_accepts_a_space_split_of_a_zoo_net(runs, name):
    """In a world of two ranks ``BCPTrainer`` takes ``sp_devices=2`` for
    every trainable zoo net (UNETR at its window), with one data index."""
    assert runs[2]["trainer"][0][name] == (1, 2)


@pytest.mark.parametrize("name", ["unet_3D", "unet_2d_bcp"])
def test_trainer_refuses_a_space_split_without_its_ranks(name, monkeypatch,
                                                         tmp_path):
    """Outside a world a split of a zoo net is refused, as the V-Net's is:
    it needs a mesh with a matching space axis."""
    _narrow(monkeypatch, name)
    base = la_config(patch_size=(16, 16, 16)) if name == "unet_3D" else \
        sr.CONFIGS["acdc"](patch_size=(32, 32))
    cfg = base.replace(net_type=name, sp_devices=2,
                       snapshot_root=str(tmp_path), compute_dtype="float32")
    with pytest.raises(ValueError, match="needs a mesh"):
        BCPTrainer(cfg, device="cpu")


# ---------------- the kernels at the zoo's halo'd slabs ----------------
def zoo_slab_shapes():
    """(B, X + 2, Y, Z, Ci, Co) of every 3^3 conv of a full-width UNet3D
    (``train_la``: 112 x 112 x 80, the self step's batch 8) and UNETR (128^3,
    batch 4 a concat forward of 2 + 2) forward on its halo'd slabs at S = 2
    and 4 that the kernels take, and the whole level where it runs
    replicated."""
    from bcp_tpu_torch.models.layers import gathered_level
    fc = (64, 256, 256, 512, 1024)
    shapes = set()
    for S in (2, 4):
        first = gathered_level(112 // S, 4)
        for lvl in range(5):
            sliced = first is None or lvl <= first
            X = (112 >> lvl) // S + 2 if sliced else 112 >> lvl
            Y, Z = 112 >> lvl, 80 >> lvl
            ci = (1,) + fc[:4]
            pairs = [(ci[lvl], fc[lvl]), (fc[lvl], fc[lvl])]
            if lvl < 4:
                pairs += [(2 * fc[lvl], fc[lvl])]
            shapes |= {(8, X, Y, Z, a, b) for a, b in pairs}
        # UNETR's decoder levels above its 8-plane token grid, all sliced
        for planes, pairs in ((16, ((512, 512), (1024, 512))),
                              (32, ((256, 256), (512, 256))),
                              (64, ((128, 128), (256, 128))),
                              (128, ((1, 32), (32, 64), (128, 64),
                                     (64, 64)))):
            shapes |= {(4, planes // S + 2, planes, planes, a, b)
                       for a, b in pairs}
    return sorted(s for s in shapes if kernel_takes(s[4], s[5]))


@pytest.mark.parametrize("shape", zoo_slab_shapes())
def test_pickers_take_every_halo_slab_of_the_zoo(shape):
    """``conv_variant`` and ``dw_variant`` give a variant at each shape
    (132 SMs, an H100 SXM's), B's fitting in shared memory and C's partial
    sums within ``DW_WORKSPACE_BYTES``."""
    from bcp_tpu_torch.ops.conv3d import (CONV_SMEM_LIMIT,
                                          DW_WORKSPACE_BYTES)
    B, X, Y, Z, ci, co = shape
    for a, b in ((ci, co), (co, ci)):     # forward, and B as dx
        v = conv_variant(B, X, Y, Z, a, b, 132)
        assert v.smem_bytes(a) <= CONV_SMEM_LIMIT
        assert (a // 16) % v.ksplit == 0
    d = dw_variant(B, X, Y, Z, ci, co, 132)
    assert ci % d.ci_tile == 0 and co % d.co_group == 0
    assert d.splits == d.cluster or \
        d.splits * 27 * ci * co * 4 <= DW_WORKSPACE_BYTES
