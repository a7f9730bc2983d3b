"""One pre-train and one self-train update of each trainable zoo net, the
port's against the JAX package's jitted steps (``make_pretrain_step`` /
``make_selftrain_step``), from the same flax variables (random norms and
BatchNorm statistics, ``torch_port_helpers.flax_zoo``), batch and mask:
``unet_3D``, ``unet_3D_dtc``, ``unetr``, ``unetr_dtc`` and ``git_VNet``
through the LA steps at 16^3, ``unet_2d_bcp`` and ``unet_tsne`` through
the ACDC steps at 32x32, at ``ZOO``'s small widths. Every dropout takes
the JAX step's own keep masks: a flax dropout's draw depends on its key
and the shape alone, so a forward with the step's key on inputs of the
step's shapes, each dropout handed ones, reads them off
(:func:`jax_keep_masks`).

Both sides run in float64, as ``tests/test_torch_steps.py`` does (UNet3D's
f32 gradient is rounding-bound at its 1^3 bottom level), with its
tolerances: losses to rtol 1e-9, each parameter update and momentum
buffer within 1e-3 of the JAX update's largest magnitude, BatchNorm
running statistics to 1e-9 of theirs. The zoo nets' concat forwards
normalise the concat batch as one (the JAX nets have no ``bn_groups``),
and the teacher's pseudo-labels of the self-train step are the JAX
teacher's, voxel for voxel. ``unet_2d_bcp`` returns a bare tensor, which
the steps take whole (the tuple rule); the DTC nets train on their tanh
head, the first element, as the JAX rule says. A parameter the loss does
not reach (the DTC nets' second head, UNet_tsne's contrastive heads) is
moved by the weight decay and its momentum alone, as optax moves it.

The net types the JAX step cannot run fail there and are refused by the
port's trainer before the first forward, by name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from bcp_tpu.config import acdc_config as jax_acdc_config
from bcp_tpu.config import la_config as jax_la_config
from bcp_tpu.models import create_model as flax_create
from bcp_tpu.ops import masks as jax_masks
from bcp_tpu.train.state import build_optimizer as jax_build_optimizer
from bcp_tpu.train.state import init_state as jax_init_state
from bcp_tpu.train.steps import (_pseudo_label, _teacher_forward,
                                 make_pretrain_step, make_selftrain_step)
from bcp_tpu_torch import convert
from bcp_tpu_torch.config import acdc_config, la_config
from bcp_tpu_torch.ops.masks import cuboid_mask
from bcp_tpu_torch.train import state as port_state
from bcp_tpu_torch.train.state import TrainState, build_optimizer
from bcp_tpu_torch.train.steps import (pretrain_step, pseudo_labels,
                                       selftrain_step)
from bcp_tpu_torch.train.trainer import BCPTrainer
from test_torch_acdc_steps import _batch as acdc_batch
from test_torch_steps import _batch as la_batch
from test_torch_steps import _close, _f64, _np, _trace
from test_torch_train_ops import jax_cuboid_starts
from torch_port_helpers import ZOO, flax_zoo, port_zoo, to_first

LA_NETS = ("unet_3D", "unet_3D_dtc", "unetr", "unetr_dtc", "git_VNet")
ACDC_NETS = ("unet_2d_bcp", "unet_tsne")
#: the nets whose layouts keep the (tokens, features) masks as they are
TOKENS = ("unetr", "unetr_dtc")
#: the nets whose heads come out in f32 whatever the compute dtype
F32_HEADS = ("unet_3D", "unet_3D_dtc", "unetr", "unetr_dtc")


def jax_keep_masks(model, variables, shape, key):
    """Every dropout's keep mask, in call order, of a train-mode forward
    of ``model`` with the dropout key ``key`` on an input of ``shape``
    (channels-last): each dropout is handed ones, so its output is
    nonzero exactly where it keeps. A channel dropout's mask is (N, C)."""
    keeps = []

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, nn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        det = kwargs.get("deterministic", args[1] if len(args) > 1
                         else mod.deterministic)
        if mod.rate == 0 or det:
            return next_fun(*args, **kwargs)
        x = args[0]
        ones = next_fun(jnp.ones_like(x), *args[1:], **kwargs)
        keep = np.asarray(ones) != 0
        out = jnp.where(keep, x / (1.0 - mod.rate), jnp.zeros_like(x))
        if mod.broadcast_dims:
            keep = keep.any(axis=tuple(mod.broadcast_dims))
        keeps.append(keep)
        return out

    with nn.intercept_methods(interceptor):
        model.apply(variables, jnp.zeros(shape, jnp.float64), train=True,
                    mutable=["batch_stats"], rngs={"dropout": key})
    return keeps


def _port_masks(name, keeps):
    return [torch.from_numpy(k) if name in TOKENS or k.ndim <= 2
            else to_first(k) for k in keeps]


def _sd(name, params, stats):
    v = {"params": params}
    if stats:
        v["batch_stats"] = stats
    return convert.state_dict_from_flax(_np(v), name, dtype=np.float64)


def _configs(name, jax_side):
    kw = dict(patch_size=(16, 16, 16), labelnum=4, compute_dtype="float32",
              net_type=name)
    if name in ACDC_NETS:
        kw = dict(labelnum=1, patch_size=(32, 32), batch_size=8,
                  labeled_bs=4, compute_dtype="float32", net_type=name)
        return (jax_acdc_config if jax_side else acdc_config)(**kw)
    return (jax_la_config if jax_side else la_config)(**kw)


def _run(name, stage):
    jax.config.update("jax_enable_x64", True)
    try:
        return _run_x64(name, stage)
    finally:
        jax.config.update("jax_enable_x64", False)


def _run_x64(name, stage):
    jcfg, cfg = _configs(name, True), _configs(name, False)
    fmodel, variables, _ = flax_zoo(name, seed=6)
    tx = jax_build_optimizer(jcfg, stage)
    st = jax_init_state(fmodel, jcfg, jax.random.PRNGKey(3), tx)
    params = _f64(variables["params"])
    stats = _f64(variables.get("batch_stats", {}))
    st = st.replace(params=params, batch_stats=stats,
                    teacher_params=_f64(params),
                    teacher_batch_stats=_f64(stats),
                    opt_state=tx.init(params))
    start = _sd(name, params, stats)
    raw = acdc_batch(4) if name in ACDC_NETS else la_batch(4)
    batch = {k: v.astype(np.float64) if v.dtype != np.uint8 else v
             for k, v in raw.items()}
    S = cfg.patch_size
    key = jax.random.PRNGKey(5)
    vs = {"params": params, "batch_stats": stats} if stats else \
        {"params": params}
    n = batch["img_a"].shape[0]
    if stage == "pre":
        mask_key, drop_key = jax.random.split(key)
        step = make_pretrain_step(fmodel, tx, jcfg)
        jbatch = {k: v for k, v in batch.items() if not k.startswith("u")}
        keep_s = jax_keep_masks(fmodel, vs, (n, *S, 1), drop_key)
    else:
        mask_key, tkey, skey = jax.random.split(key, 3)
        step = make_selftrain_step(fmodel, tx, jcfg)
        jbatch = batch
        keep_t = jax_keep_masks(fmodel, vs, (2 * n, *S, 1), tkey)
        keep_s = jax_keep_masks(fmodel, vs, (2 * n, *S, 1), skey)
        u = jnp.concatenate([batch["uimg_a"], batch["uimg_b"]])
        want_plab = np.asarray(_pseudo_label(jcfg, _teacher_forward(
            fmodel, params, stats, u, tkey)))
    new, jmetrics = step(st, jbatch, key)
    new = _np(new)

    # port_zoo loads before its cast to f64: the f64 start goes in after
    f64 = _np({"params": params, "batch_stats": stats})
    model = port_zoo(name, f64, mode="train", dtype=np.float64)
    teacher = port_zoo(name, f64, mode="train", dtype=np.float64)
    model.load_state_dict(start, strict=True)
    teacher.load_state_dict(start, strict=True)
    for p in teacher.parameters():
        p.requires_grad_(False)
    state = TrainState(model, teacher, build_optimizer(cfg,
                                                       model.parameters()))
    if name in ACDC_NETS:
        pbatch = {k: (torch.from_numpy(v).permute(0, 3, 1, 2) if v.ndim == 4
                      else torch.from_numpy(v)) for k, v in jbatch.items()}
    else:
        pbatch = {k: (torch.from_numpy(v).permute(0, 4, 1, 2, 3)
                      if v.ndim == 5 else torch.from_numpy(v))
                  for k, v in jbatch.items()}
    mask = cuboid_mask(S, jax_cuboid_starts(mask_key, S))
    assert torch.equal(mask, torch.from_numpy(np.asarray(
        jax_masks.cuboid_mask(mask_key, S))).to(mask.dtype))
    plabs = None
    if stage == "pre":
        metrics = pretrain_step(state, pbatch, mask, cfg,
                                dropout=_port_masks(name, keep_s))
    else:
        got_plab = pseudo_labels(state, pbatch, cfg,
                                 _port_masks(name, keep_t)).numpy()
        plabs = (got_plab, want_plab)
        metrics = selftrain_step(state, pbatch, mask, cfg,
                                 _port_masks(name, keep_t),
                                 _port_masks(name, keep_s))
    return start, new, jmetrics, state, metrics, plabs


def cases(names):
    return [f"{name}-{stage}" for name in names for stage in ("pre", "self")]


#: the slower half of the nets here, the rest in
#: ``test_torch_zoo_steps_unetr_2d.py`` (the test files run in parallel)
@pytest.fixture(scope="module",
                params=cases(("unet_3D", "unet_3D_dtc", "git_VNet")))
def stepped(request):
    name, stage = request.param.split("-")
    return name, stage, _run(name, stage)


def test_losses_match(stepped):
    """To rtol 1e-9; 1e-6 for the nets whose heads come out in f32 on both
    sides (UNet3D's and UNETR's, as the JAX package casts them), where the
    losses are f32 sums."""
    name, _, (_, _, jmetrics, state, metrics, _) = stepped
    assert state.step == 1
    assert set(metrics) == set(jmetrics)
    rtol = 1e-6 if name in F32_HEADS else 1e-9
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), rtol=rtol,
                                   err_msg=k)


def test_param_deltas_and_bn_stats_match(stepped):
    """Every parameter's update; the running statistics of the nets with
    BatchNorm (one group: the zoo's concat forward normalises the concat
    batch as one, as the JAX step does)."""
    name, _, (start, new, _, state, _, _) = stepped
    want = _sd(name, new.params, new.batch_stats)
    moved = stats = 0
    for k, v in state.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            _close(v, want[k], k, rel=1e-9)
            stats += 1
            continue
        _close(v - start[k], want[k] - start[k], k)
        moved += bool((want[k] - start[k]).abs().max() > 1e-9)
    assert moved > len(list(state.model.parameters())) // 2
    assert stats or not any(k.endswith("running_mean") for k in want)


def test_num_batches_tracked_counts_one_group(stepped):
    """A zoo net's BatchNorm counts one batch a forward: the concat
    forward is one batch (the V-Net's and U-Net's count two); those of
    heads the step does not run (UNet_tsne's contrastive heads) none."""
    _, stage, (_, _, _, state, _, _) = stepped
    counts = {int(v) for k, v in state.model.state_dict().items()
              if k.endswith("num_batches_tracked")}
    assert counts <= {0, 1}
    teacher = {int(v) for k, v in state.teacher.state_dict().items()
               if k.endswith("num_batches_tracked")}
    assert teacher <= {0}


def test_momentum_buffers_match(stepped):
    name, _, (_, new, _, state, _, _) = stepped
    want = _sd(name, _trace(new.opt_state), new.batch_stats)
    opt = state.optimizer
    for k, p in state.model.named_parameters():
        _close(opt.state[p]["momentum_buffer"], want[k], k)


def test_teacher_matches(stepped):
    """Pre-train leaves the teacher alone; self-train moves its parameters
    by the EMA of the new student (and, ACDC's full-state EMA, its BN
    statistics)."""
    name, stage, (start, new, _, state, _, _) = stepped
    want = _sd(name, new.teacher_params, new.teacher_batch_stats)
    for k, v in state.teacher.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if stage == "pre":
            assert torch.equal(v, start[k]), k
        elif k.endswith(("running_mean", "running_var")):
            _close(v, want[k], k, rel=1e-9)
        else:
            _close(v - start[k], want[k] - start[k], k)


def test_teacher_pseudo_labels_match(stepped):
    """The self-train step's pseudo-labels (the teacher's concat forward,
    its threshold or argmax, the NMS) equal the JAX teacher's."""
    _, stage, (*_, plabs) = stepped
    if stage == "pre":
        assert plabs is None
        return
    got, want = plabs
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the net types the JAX step cannot run

#: (net type, JAX config maker, patch, factory kwargs, JAX error)
REFUSED = {
    "unet_3D_trilinear": ("la", (16, 16, 16), ZOO["unet_3D_trilinear"][0],
                          "output maps"),
    "sep_unet_2d": ("acdc", (112, 112), ZOO["sep_unet_2d"][0],
                    "pooled bottleneck"),
    "unetr": ("la", (32, 16, 16), ZOO["unetr"][0], "window"),
    "unetr_dtc": ("la", (32, 16, 16), ZOO["unetr_dtc"][0], "window"),
    "net_D": ("la", (16, 16, 16), dict(b_size=2), "discriminator"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
@pytest.mark.parametrize("stage", ["pre", "self"])
def test_jax_step_fails_on_refused_nets(name, stage):
    variant, patch, kw, _ = REFUSED[name]
    jcfg = (jax_la_config if variant == "la" else jax_acdc_config)(
        patch_size=patch, labelnum=4 if variant == "la" else 1,
        compute_dtype="float32", batch_size=8, labeled_bs=4)
    model = flax_create(name, 4 if variant == "acdc" else 2, **kw)
    rng = np.random.default_rng(0)
    batch = {}
    for k in "ab":
        for key in (f"img_{k}", f"uimg_{k}"):
            batch[key] = rng.normal(size=(2, *patch, 1)).astype(np.float32)
        batch[f"lab_{k}"] = rng.integers(0, 2, (2, *patch)).astype(np.uint8)
    tx = jax_build_optimizer(jcfg, stage)
    with pytest.raises(Exception):
        st = jax_init_state(model, jcfg, jax.random.PRNGKey(0), tx)
        make = make_pretrain_step if stage == "pre" else make_selftrain_step
        if stage == "pre":
            batch = {k: v for k, v in batch.items() if not k.startswith("u")}
        _, metrics = make(model, tx, jcfg)(st, batch, jax.random.PRNGKey(1))
        jax.block_until_ready(metrics)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_port_trainer_refuses_by_name(name, monkeypatch, tmp_path):
    """The trainer refuses before any forward, naming the net and the
    reason; UNETR at the window it is built for is taken."""
    variant, patch, kw, reason = REFUSED[name]
    make = port_state.create_model

    def small(net_type, *a, **k):
        k.pop("n_filters", None)
        return make(net_type, *a, **{**kw, **k})
    monkeypatch.setattr(port_state, "create_model", small)
    cfg = (la_config if variant == "la" else acdc_config)(
        patch_size=patch, net_type=name, snapshot_root=str(tmp_path),
        compute_dtype="float32")
    with pytest.raises(ValueError, match=f"{name}'.*{reason}"):
        BCPTrainer(cfg, device="cpu")
    if name.startswith("unetr"):
        BCPTrainer(cfg.replace(patch_size=kw["img_shape"]), device="cpu")
