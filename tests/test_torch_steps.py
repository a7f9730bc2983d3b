"""One pre-train and one self-train update of the port against the JAX
package's jitted steps (``make_pretrain_step`` / ``make_selftrain_step``),
from the same converted weights and batch, with the JAX step's own mask
draws handed to the port and dropout off on both sides. Compared per
tensor: parameters, BN running statistics, the teacher and the SGD
momentum buffers. V-Net n_filters 16 at a 16^3 patch, so the 20 3^3 convs
run through ``Conv3x3x3Function``; the self-train update runs a second
time with ``fused_bwd=True`` (every conv's backward through the fused
wrapper), against the same JAX step.

Both sides run in float64, as the JAX package's own one-step fidelity
gates do (`tests/test_train_fidelity.py:35-37`): in f32 the V-Net's
BatchNorm chains amplify reassociation noise to several percent of the
small deep-layer gradients. Each update is compared as a delta, within
1e-3 of the JAX delta's own largest magnitude.

The self-train update also runs with ``fuse_subbatches=False`` on both
sides (the JAX package's two teacher and two student forwards, the
running statistics threaded from the first student forward into the
second; the port's one concat forward with 2-group BatchNorm), at the
same tolerances; and the reference's two-forward route, run on the
port's networks, equals the port's step in f64 to 1e-10."""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcp_tpu.config import la_config as jax_la_config
from bcp_tpu.models import VNet3D as FlaxVNet3D
from bcp_tpu.train.state import build_optimizer as jax_build_optimizer
from bcp_tpu.train.state import init_state as jax_init_state
from bcp_tpu.train.steps import make_pretrain_step, make_selftrain_step
from bcp_tpu_torch import convert
from bcp_tpu_torch.config import acdc_config, la_config, pancreas_config
from bcp_tpu_torch.models import VNet3D
from bcp_tpu_torch.models.layers import Dropout, bn_groups
from bcp_tpu_torch.ops.masks import cuboid_mask
from bcp_tpu_torch.train.state import TrainState, build_optimizer, init_state
from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
from bcp_tpu_torch.train.trainer import copy_paste_mask
from test_torch_train_ops import jax_cuboid_starts

PATCH = (16, 16, 16)
NF = 16


def _batch(seed):
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s) for s in PATCH], indexing="ij"))
    out = {}
    for k in ("a", "b"):
        c = rng.uniform(5, 11, size=(2, 3, 1, 1, 1))
        lab = ((g[None] - c) ** 2).sum(1) <= rng.uniform(16, 30)
        out[f"lab_{k}"] = lab.astype(np.uint8)
        out[f"img_{k}"] = (rng.normal(0, 0.3, (2, *PATCH))
                           + lab)[..., None].astype(np.float32)
        out[f"uimg_{k}"] = (rng.normal(0, 0.3, (2, *PATCH)) + (
            ((g[None] - c[::-1]) ** 2).sum(1) <= 25))[..., None].astype(
            np.float32)
    return out


def _to_port(batch):
    return {k: (torch.from_numpy(v).permute(0, 4, 1, 2, 3) if v.ndim == 5
                else torch.from_numpy(v)) for k, v in batch.items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _sd(params, stats):
    """``convert.state_dict_from_flax`` keeping float64."""
    return convert.state_dict_from_flax(
        _np({"params": params, "batch_stats": stats}), dtype=np.float64)


def _trace(opt_state):
    for part in opt_state:
        if hasattr(part, "trace"):
            return part.trace
    raise AssertionError("no momentum trace in the optax state")


def _close(got: torch.Tensor, want: torch.Tensor, what: str,
           rel: float = 1e-3):
    """max|got - want| <= rel * max|want|, with a 1e-9 floor for tensors
    that (numerically) do not move, e.g. conv biases in front of a
    BatchNorm."""
    err = (got.detach() - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= max(rel * scale, 1e-9), f"{what}: err {err} scale {scale}"


def _run(stage, fused=False, unfused=False):
    jax.config.update("jax_enable_x64", True)
    try:
        return _run_x64(stage, fused, unfused)
    finally:
        jax.config.update("jax_enable_x64", False)


def _run_x64(stage, fused, unfused):
    kw = dict(n_filters=NF, patch_size=PATCH, labelnum=4,
              compute_dtype="float32", fuse_subbatches=not unfused)
    jcfg = jax_la_config(**kw)
    cfg = la_config(**kw)
    fmodel = FlaxVNet3D(n_classes=2, n_filters=NF, normalization="batchnorm",
                        has_dropout=False)
    tx = jax_build_optimizer(jcfg, stage)
    st = jax_init_state(fmodel, jcfg, jax.random.PRNGKey(3), tx)
    params, stats = _f64(st.params), _f64(st.batch_stats)
    st = st.replace(params=params, batch_stats=stats,
                    teacher_params=_f64(params), teacher_batch_stats=_f64(
                        stats), opt_state=tx.init(params))
    start = _sd(params, stats)
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
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

    model = VNet3D(n_classes=2, n_filters=NF, fused_bwd=fused).double()
    model.load_state_dict(start, strict=True)
    model.train()
    teacher = copy.deepcopy(model)
    state = TrainState(model, teacher, build_optimizer(cfg,
                                                       model.parameters()))
    mask = cuboid_mask(PATCH, jax_cuboid_starts(mask_key, PATCH))
    pbatch = _to_port(jbatch)
    if stage == "pre":
        metrics = pretrain_step(state, pbatch, mask, cfg)
    else:
        metrics = selftrain_step(state, pbatch, mask, cfg)
    return start, new, jmetrics, state, metrics


@pytest.fixture(scope="module", params=["pre", "self", "self_fused",
                                        "self_unfused"])
def stepped(request):
    stage, _, route = request.param.partition("_")
    return stage, _run(stage, fused=route == "fused",
                       unfused=route == "unfused")


def test_losses_match(stepped):
    _, (_, new, jmetrics, state, metrics) = stepped
    assert state.step == 1
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
    # of 114 parameters, the 20 3^3 convs' biases stay (zero at init and
    # in front of a BatchNorm: no gradient, no decay); a few more move by
    # less than the 1e-9 floor
    assert moved >= 86


def test_momentum_buffers_match(stepped):
    """The first momentum buffer is the decayed gradient."""
    _, (_, new, _, state, _) = stepped
    want = _sd(_trace(new.opt_state), new.batch_stats)
    opt = state.optimizer
    for k, p in state.model.named_parameters():
        _close(opt.state[p]["momentum_buffer"], want[k], k)


def test_teacher_matches(stepped):
    """Pre-train leaves the teacher alone; self-train moves its parameters
    by the EMA of the new student and keeps its BN buffers."""
    stage, (start, new, _, state, _) = stepped
    want = _sd(new.teacher_params, new.teacher_batch_stats)
    for k, v in state.teacher.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if stage == "pre" or k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, start[k]), k
        else:
            _close(v - start[k], want[k] - start[k], k)


@contextlib.contextmanager
def _two_forwards(*nets):
    """The reference's unfused route (`steps.py:267-289,298-311`) on the
    port's networks: a forward of a concat batch runs as two forwards,
    one a half, each with one-group BatchNorm, so the running statistics
    thread from the first into the second."""
    for net in nets:
        def forward(x, _net=net, _orig=net.forward):
            with bn_groups(_net, 1):
                outs = [_orig(h) for h in x.chunk(2)]
            return tuple(torch.cat(o) for o in zip(*outs))
        net.forward = forward
    try:
        yield
    finally:
        for net in nets:
            del net.forward


@pytest.mark.parametrize("variant", ["la", "acdc", "pancreas"])
def test_unfused_equals_fused_in_f64(variant):
    """``fuse_subbatches=False`` runs the concat forward with 2-group
    BatchNorm; the reference's two forwards a network (:func:`_two_forwards`)
    land on its losses, student, BN statistics (num_batches_tracked
    included), momentum buffers or Adam moments and teacher to 1e-10 in
    f64, dropout off, from one state, batch and mask."""
    cfg = {"la": lambda: la_config(n_filters=4, patch_size=(16,) * 3,
                                   labelnum=4, compute_dtype="float32"),
           "acdc": lambda: acdc_config(n_filters=4, patch_size=(32, 32),
                                       compute_dtype="float32"),
           "pancreas": lambda: pancreas_config(
               20, n_filters=4, patch_size=(16,) * 3, mask_patch=8,
               compute_dtype="float32")}[variant]()
    rng = np.random.default_rng(0)
    S = cfg.patch_size
    batch = {}
    for k in "ab":
        for key in (f"img_{k}", f"uimg_{k}"):
            batch[key] = torch.from_numpy(rng.normal(size=(2, 1, *S)))
        batch[f"lab_{k}"] = torch.from_numpy(
            rng.integers(0, cfg.num_classes, (2, *S)).astype(np.uint8))
    fused = init_state(cfg, "cpu")
    for net in (fused.model, fused.teacher):
        net.double()
        for m in net.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    fused.optimizer = type(fused.optimizer)(fused.model.parameters(),
                                            **fused.optimizer.defaults)
    unfused = copy.deepcopy(fused)
    mask = copy_paste_mask(cfg, np.random.default_rng(1))
    want = selftrain_step(fused, batch, mask,
                          cfg.replace(fuse_subbatches=False))
    with _two_forwards(unfused.model, unfused.teacher):
        got = selftrain_step(unfused, batch, mask, cfg)
    for k, v in want.items():
        assert abs(got[k].item() - v.item()) <= 1e-10, k
    for part in ("model", "teacher"):
        a = getattr(fused, part).state_dict()
        b = getattr(unfused, part).state_dict()
        for k, v in a.items():
            if v.is_floating_point():
                assert (b[k] - v).abs().max().item() <= 1e-10, (part, k)
            else:
                assert torch.equal(b[k], v), (part, k)
    for p, q in zip(fused.model.parameters(), unfused.model.parameters()):
        for k, v in fused.optimizer.state[p].items():
            assert (unfused.optimizer.state[q][k] - v).abs().max().item() \
                <= 1e-10, k
