"""One pancreas pre-train and one self-train update of the port against the
JAX package's jitted steps (``make_pretrain_step`` /
``make_selftrain_step`` with the pancreas preset), from the same converted
weights and batch, with the JAX step's own mask draws handed to the port:
the instance-norm V-Net at n_filters 16 (so its 20 3^3 convs run through
``Conv3x3x3Function``) on 32^3 patches, batch 8, Adam, the fixed copy-paste
cube (16^3 here: 64^3 does not fit a 32^3 patch), pancreas' mix order and
losses, binary pseudo-labels with largest-CC NMS at connectivity 2, and
the EMA of the parameters only. Then the self-train update again from the
pre-train state handed over with its optimizer (``load_opt_state``),
against ``CheckpointIO.restore_with_opt`` and the JAX step, and the
self-train update with ``fuse_subbatches=False`` on both sides (the JAX
package's two forwards a network, the port's concat forward; the
instance norm has no running statistics).

Float64 on both sides, as ``test_torch_steps.py``. Every parameter delta,
teacher delta and Adam moment within 1e-3 of the JAX tensor's largest
magnitude (a 1e-9 floor for those that do not move: in exact arithmetic
the biases of the convs in front of an instance norm get no gradient, and
in f64 Adam leaves their rounding noise, well under eps, below the floor),
the metrics (``train_dice`` included) to rtol 1e-9."""

import copy

import jax
import numpy as np
import pytest
import torch

from bcp_tpu.config import pancreas_config as jax_pancreas_config
from bcp_tpu.models import VNet3D as FlaxVNet3D
from bcp_tpu.train.checkpoints import CheckpointIO
from bcp_tpu.train.state import build_optimizer as jax_build_optimizer
from bcp_tpu.train.state import init_state as jax_init_state
from bcp_tpu.train.steps import make_pretrain_step, make_selftrain_step
from bcp_tpu_torch import convert
from bcp_tpu_torch.config import pancreas_config
from bcp_tpu_torch.models import VNetPancreas
from bcp_tpu_torch.ops.masks import cuboid_mask_fixed
from bcp_tpu_torch.train.checkpoints import (load_optimizer_state,
                                             save_many, snapshot)
from bcp_tpu_torch.train.state import (TrainState, build_optimizer,
                                       load_with_opt)
from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
from test_torch_pancreas_ops import jax_fixed_starts
from test_torch_steps import _close, _f64, _np

PATCH = (32, 32, 32)
NF = 16
CUBE = 16
CFG = dict(n_filters=NF, patch_size=PATCH, mask_patch=CUBE,
           compute_dtype="float32")


def _batch(seed):
    """Blob volumes: labelled pairs with their labels, unlabelled pairs
    whose blobs sit elsewhere."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(s) for s in PATCH], indexing="ij"))
    out = {}
    for k in ("a", "b"):
        c = rng.uniform(10, 22, size=(2, 3, 1, 1, 1))
        lab = ((g[None] - c) ** 2).sum(1) <= rng.uniform(40, 80)
        out[f"lab_{k}"] = lab.astype(np.uint8)
        out[f"img_{k}"] = (rng.normal(0, 0.3, (2, *PATCH))
                           + lab)[..., None]
        out[f"uimg_{k}"] = (rng.normal(0, 0.3, (2, *PATCH)) + (
            ((g[None] - c[::-1]) ** 2).sum(1) <= 60))[..., None]
    return out


def _to_port(batch):
    return {k: (torch.from_numpy(v).permute(0, 4, 1, 2, 3) if v.ndim == 5
                else torch.from_numpy(v)) for k, v in batch.items()}


def _sd(params):
    return convert.state_dict_from_flax(_np({"params": params}),
                                        "VNet_pancreas", dtype=np.float64)


def _adam(opt_state):
    """optax's (mu, nu, count) of ``optax.adam``."""
    for part in opt_state:
        if hasattr(part, "mu"):
            return part.mu, part.nu, int(part.count)
    raise AssertionError("no Adam moments in the optax state")


def _port_state(cfg, start):
    model = VNetPancreas(n_filters=NF).double()
    model.load_state_dict(start, strict=True)
    model.train()
    teacher = copy.deepcopy(model)
    for p in teacher.parameters():
        p.requires_grad_(False)
    return TrainState(model, teacher, build_optimizer(cfg,
                                                      model.parameters()))


def _run(tmp):
    jax.config.update("jax_enable_x64", True)
    try:
        return _run_x64(tmp)
    finally:
        jax.config.update("jax_enable_x64", False)


def _run_x64(tmp):
    """{"pre", "self", "handoff"}: (start state_dict, JAX state after,
    JAX metrics, port state after, port metrics)."""
    jcfg = jax_pancreas_config(**CFG)
    cfg = pancreas_config(**CFG)
    fmodel = FlaxVNet3D(n_classes=2, n_filters=NF,
                        normalization="instancenorm", has_dropout=False)
    tx = jax_build_optimizer(jcfg, "pre")
    init = jax_init_state(fmodel, jcfg, jax.random.PRNGKey(3), tx)
    params = _np(_f64(init.params))

    def fresh():
        """A new f64 JAX state at the start (a step donates its state)."""
        p = _f64(params)
        return init.replace(step=jax.numpy.zeros((), jax.numpy.int32),
                            params=p, batch_stats={},
                            teacher_params=_f64(params),
                            teacher_batch_stats={}, opt_state=tx.init(p))
    start = _sd(params)
    batch = {k: v.astype(np.float64) if v.dtype != np.uint8 else v
             for k, v in _batch(4).items()}
    pbatch = _to_port(batch)
    pre_batch = {k: v for k, v in batch.items() if not k.startswith("u")}
    pre_fn = make_pretrain_step(fmodel, tx, jcfg)
    self_fn = make_selftrain_step(fmodel, jax_build_optimizer(jcfg, "self"),
                                  jcfg)
    out = {}

    def port_step(stage, state, key, cfg=cfg):
        if stage == "pre":
            mask_key = jax.random.split(key)[0]
        else:
            mask_key = jax.random.split(key, 3)[0]
        mask = cuboid_mask_fixed(PATCH, jax_fixed_starts(mask_key, PATCH,
                                                         CUBE), CUBE)
        if stage == "pre":
            return pretrain_step(state, {k: pbatch[k] for k in pre_batch},
                                 mask, cfg)
        return selftrain_step(state, pbatch, mask, cfg)

    key = jax.random.PRNGKey(5)
    jpre, jm = pre_fn(fresh(), pre_batch, key)
    jpre = _np(jpre)
    pre = _port_state(cfg, start)
    out["pre"] = (start, jpre, jm, pre, port_step("pre", pre, key))

    key = jax.random.PRNGKey(6)
    jself, jm = self_fn(fresh(), batch, key)
    state = _port_state(cfg, start)
    out["self"] = (start, _np(jself), jm, state,
                   port_step("self", state, key))

    # two forwards a network (`steps.py:267-289,298-311`)
    unfused_fn = make_selftrain_step(
        fmodel, jax_build_optimizer(jcfg, "self"),
        jcfg.replace(fuse_subbatches=False))
    jself, jm = unfused_fn(fresh(), batch, key)
    state = _port_state(cfg, start)
    out["self_unfused"] = (start, _np(jself), jm, state, port_step(
        "self", state, key, cfg.replace(fuse_subbatches=False)))

    # the hand-off: the pre-train state's weights and Adam state into a
    # fresh self-train state (`checkpoints.py:116-130`), then one step
    io = CheckpointIO()
    path = str(tmp / "jax_pre_best")
    io.save(path, jax.tree_util.tree_map(jax.numpy.asarray, jpre))
    jhand, jm = self_fn(io.restore_with_opt(path, fresh()), batch, key)
    pth = str(tmp / "VNet_pancreas_best_model.pth")
    save_many([pth], snapshot(pre), with_opt=True)
    hand = _port_state(cfg, start)
    load_with_opt(hand, convert.load_reference_checkpoint(
        pth, "VNet_pancreas"), load_optimizer_state(pth))
    handed = _sd(jpre.params)
    out["handoff"] = (handed, _np(jhand), jm, hand,
                      port_step("self", hand, key))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("pancreas_steps"))


STAGES = ["pre", "self", "self_unfused", "handoff"]


@pytest.mark.parametrize("stage", STAGES)
def test_metrics_match(runs, stage):
    _, _, jmetrics, state, metrics = runs[stage]
    assert state.step == 1
    want = {"loss", "loss_dice", "loss_ce", "train_dice"} if stage == "pre" \
        else {"loss", "loss_l", "loss_u"}
    assert set(metrics) == want == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), rtol=1e-9,
                                   err_msg=k)
    if stage == "pre":
        assert 0.0 < metrics["train_dice"].item() < 1.0


@pytest.mark.parametrize("stage", STAGES)
def test_param_deltas_match(runs, stage):
    start, new, _, state, _ = runs[stage]
    want = _sd(new.params)
    moved = 0
    for k, v in state.model.state_dict().items():
        _close(v - start[k], want[k] - start[k], k)
        moved += bool((want[k] - start[k]).abs().max() > 1e-9)
    # Adam moves every parameter by about lr whose gradient is above its
    # eps: of 60, the 29 weights and out_conv's bias; the 30 biases in
    # front of an instance norm have no gradient in exact arithmetic
    assert moved >= 30


@pytest.mark.parametrize("stage", STAGES)
def test_adam_moments_and_count_match(runs, stage):
    """Adam's first and second moments per tensor, and the step count: 1
    after a fresh stage's step, 2 after the hand-off's (bias correction
    goes on from the pre-train state, as optax's ``count``)."""
    _, new, _, state, _ = runs[stage]
    mu, nu, count = _adam(new.opt_state)
    assert count == (2 if stage == "handoff" else 1)
    mu, nu = _sd(mu), _sd(nu)
    opt = state.optimizer
    for k, p in state.model.named_parameters():
        s = opt.state[p]
        assert int(s["step"]) == count, k
        _close(s["exp_avg"], mu[k], f"{k} exp_avg")
        _close(s["exp_avg_sq"], nu[k], f"{k} exp_avg_sq", rel=1e-3)


@pytest.mark.parametrize("stage", STAGES)
def test_teacher_matches(runs, stage):
    """Pre-train leaves the teacher alone; self-train moves it by the EMA
    of the new student's parameters (there are no buffers)."""
    start, new, _, state, _ = runs[stage]
    want = _sd(new.teacher_params)
    assert not list(state.teacher.buffers())
    for k, v in state.teacher.state_dict().items():
        if stage == "pre":
            assert torch.equal(v, start[k]), k
        else:
            _close(v - start[k], want[k] - start[k], k)
