"""One ACDC pre-train and one ACDC self-train update of the port against
the JAX package's jitted steps (``make_pretrain_step`` /
``make_selftrain_step`` with the ACDC preset), from the same converted
weights and batch, with the JAX step's own mask draws handed to the port
and dropout off on both sides: the 2-D U-Net at n_filters 4 on 32x32
slices, batch 8 (2 + 2 labelled, 2 + 2 unlabelled), 4 classes, the argmax
pseudo-labels cleaned class by class, ACDC's mix order and losses, and the
EMA of the whole state. Float64 on both sides, as ``test_torch_steps.py``:
losses to rtol 1e-9, each parameter update and momentum buffer within 1e-3
of the JAX update's largest magnitude, BN running statistics to 1e-9. The
self-train update runs a second time with ``fuse_subbatches=False`` on
both sides (the JAX package's two forwards a network, the port's concat
forward with 2-group BatchNorm), at the same tolerances."""

import copy

import jax
import numpy as np
import pytest
import torch

from bcp_tpu.config import acdc_config as jax_acdc_config
from bcp_tpu.models import UNet2D as FlaxUNet2D
from bcp_tpu.train.state import build_optimizer as jax_build_optimizer
from bcp_tpu.train.state import init_state as jax_init_state
from bcp_tpu.train.steps import make_pretrain_step, make_selftrain_step
from bcp_tpu_torch import convert
from bcp_tpu_torch.config import acdc_config
from bcp_tpu_torch.models import UNet2D
from bcp_tpu_torch.ops.masks import cuboid_mask
from bcp_tpu_torch.train.state import TrainState, build_optimizer
from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
from test_torch_steps import _close, _f64, _np, _trace
from test_torch_train_ops import jax_cuboid_starts
from torch_port_helpers import unet_chns

PATCH = (32, 32)
NF = 4
NO_DROP = (0.0,) * 5


def _batch(seed):
    """Blob slices of 4 classes; the unlabelled images hold blobs too, so
    the teacher's argmax has components for the NMS to clean."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s) for s in PATCH], indexing="ij"))
    out = {}
    for k in ("a", "b", "ua", "ub"):
        lab = np.zeros((2, *PATCH), np.uint8)
        for c in range(1, 4):
            ctr = rng.uniform(6, 26, size=(2, 2, 1, 1))
            lab[((g[None] - ctr) ** 2).sum(1) <= rng.uniform(12, 40)] = c
        img = (rng.normal(0, 0.3, (2, *PATCH)) + 0.5 * lab)[..., None]
        if k.startswith("u"):
            out[f"uimg_{k[1]}"] = img
        else:
            out[f"img_{k}"], out[f"lab_{k}"] = img, lab
    return out


def _to_port(batch):
    return {k: (torch.from_numpy(v).permute(0, 3, 1, 2) if v.ndim == 4
                else torch.from_numpy(v)) for k, v in batch.items()}


def _sd(params, stats):
    return convert.state_dict_from_flax(
        _np({"params": params, "batch_stats": stats}), "unet",
        dtype=np.float64)


def _run(stage, unfused=False):
    jax.config.update("jax_enable_x64", True)
    try:
        return _run_x64(stage, unfused)
    finally:
        jax.config.update("jax_enable_x64", False)


def _run_x64(stage, unfused):
    kw = dict(labelnum=1, n_filters=NF, patch_size=PATCH, batch_size=8,
              labeled_bs=4, compute_dtype="float32",
              fuse_subbatches=not unfused)
    jcfg = jax_acdc_config(**kw)
    cfg = acdc_config(**kw)
    fmodel = FlaxUNet2D(n_classes=4, feature_chns=unet_chns(NF),
                        dropout=NO_DROP)
    tx = jax_build_optimizer(jcfg, stage)
    st = jax_init_state(fmodel, jcfg, jax.random.PRNGKey(3), tx)
    params, stats = _f64(st.params), _f64(st.batch_stats)
    st = st.replace(params=params, batch_stats=stats,
                    teacher_params=_f64(params),
                    teacher_batch_stats=_f64(stats),
                    opt_state=tx.init(params))
    start = _sd(params, stats)
    batch = {k: v.astype(np.float64) if v.dtype != np.uint8 else v
             for k, v in _batch(4).items()}
    key = jax.random.PRNGKey(5)
    if stage == "pre":
        mask_key = jax.random.split(key)[0]
        step = make_pretrain_step(fmodel, tx, jcfg)
        jbatch = {k: v for k, v in batch.items() if not k.startswith("u")}
    else:
        mask_key = jax.random.split(key, 3)[0]
        step = make_selftrain_step(fmodel, tx, jcfg)
        jbatch = batch
    new, jmetrics = step(st, jbatch, key)
    new = _np(new)

    model = UNet2D(feature_chns=unet_chns(NF), dropout=NO_DROP).double()
    model.load_state_dict(start, strict=True)
    model.train()
    teacher = copy.deepcopy(model)
    state = TrainState(model, teacher,
                       build_optimizer(cfg, model.parameters()))
    mask = cuboid_mask(PATCH, jax_cuboid_starts(mask_key, PATCH))
    pbatch = _to_port(jbatch)
    if stage == "pre":
        metrics = pretrain_step(state, pbatch, mask, cfg)
    else:
        metrics = selftrain_step(state, pbatch, mask, cfg)
    return start, new, jmetrics, state, metrics


@pytest.fixture(scope="module", params=["pre", "self", "self_unfused"])
def stepped(request):
    stage, _, route = request.param.partition("_")
    return stage, _run(stage, unfused=route == "unfused")


def test_losses_match(stepped):
    _, (_, _, jmetrics, state, metrics) = stepped
    assert state.step == 1
    assert set(metrics) == {"loss", "loss_dice", "loss_ce"}
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), rtol=1e-9,
                                   err_msg=k)


def test_param_deltas_and_bn_stats_match(stepped):
    _, (start, new, _, state, _) = stepped
    want = _sd(new.params, new.batch_stats)
    moved = 0
    for k, v in state.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            _close(v, want[k], k, rel=1e-9)
            continue
        _close(v - start[k], want[k] - start[k], k)
        moved += bool((want[k] - start[k]).abs().max() > 1e-9)
    # of 82 parameters, the 18 biases of the convs in front of a BatchNorm
    # have no gradient in exact arithmetic; a few more move by less than
    # the 1e-9 floor
    assert moved >= 60


def test_momentum_buffers_match(stepped):
    _, (_, new, _, state, _) = stepped
    want = _sd(_trace(new.opt_state), new.batch_stats)
    opt = state.optimizer
    for k, p in state.model.named_parameters():
        _close(opt.state[p]["momentum_buffer"], want[k], k)


def test_teacher_matches(stepped):
    """Pre-train leaves the teacher alone. Self-train moves the teacher's
    parameters and, ACDC's full-state EMA, its BN running statistics by
    the EMA of the new student; its num_batches_tracked stays."""
    stage, (start, new, _, state, _) = stepped
    want = _sd(new.teacher_params, new.teacher_batch_stats)
    stats_moved = 0
    for k, v in state.teacher.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 0, k
        elif stage == "pre":
            assert torch.equal(v, start[k]), k
        elif k.endswith(("running_mean", "running_var")):
            _close(v, want[k], k, rel=1e-9)
            stats_moved += not torch.equal(v, start[k])
        else:
            _close(v - start[k], want[k] - start[k], k)
    if stage == "self":
        assert stats_moved == 36
