"""One data-parallel update of each pipeline over two gloo ranks
(``parallel.mesh``) against the same update in one process on the global
batch, and against the JAX package's data-parallel step on a two-device
mesh of the virtual CPU devices (``num_devices=2``, as
``tests/test_parallel.py::test_dp_matches_single_device`` builds it).

The cases: an LA pre-train and self-train update (the V-Net's grouped
BatchNorm over the global batch, masked Dice and CE, SGD), an ACDC
self-train update (the U-Net, per-class Dice over the global batch, the
full-state EMA) and a pancreas self-train update (instance norm, Adam).
Each rank holds the reference batch (2 + 2 labelled, 2 + 2 unlabelled
rows), the global batch is twice it. Dropout is off; the JAX step's own
mask draws go to the port. Float64 throughout.

- Two ranks against one process: the losses to rtol 1e-10; every update
  (parameters, teacher, optimizer state) within 1e-10 of the one-process
  update's largest magnitude per tensor (a 1e-12 floor for tensors that
  do not move: the biases of the convs in front of an instance norm get
  no gradient in exact arithmetic, and Adam turns their f64 rounding
  noise, ~1e-17 and summed in another order over two ranks, into moves of
  about lr * g / eps = 1e-12), the running statistics within 1e-10 of their own
  magnitude, ``num_batches_tracked`` equal. The ranks end in the same
  state, bit for bit.
- Two ranks against the JAX package's data-parallel step: the tolerances
  of ``test_torch_steps.py``: losses to rtol 1e-9, updates within 1e-3 of
  the JAX update's largest magnitude, running statistics to 1e-9.

The ranks run in one spawned world for all four cases."""

import jax
import numpy as np
import pytest

from bcp_tpu.config import acdc_config as jax_acdc_config
from bcp_tpu.config import la_config as jax_la_config
from bcp_tpu.config import pancreas_config as jax_pancreas_config
from bcp_tpu.models import UNet2D as FlaxUNet2D
from bcp_tpu.models import VNet3D as FlaxVNet3D
from bcp_tpu.parallel import make_mesh, replicate_state, shard_batch
from bcp_tpu.train.state import build_optimizer as jax_build_optimizer
from bcp_tpu.train.state import init_state as jax_init_state
from bcp_tpu.train.steps import make_pretrain_step, make_selftrain_step
from bcp_tpu_torch import convert
from bcp_tpu_torch.ops.masks import cuboid_mask, cuboid_mask_fixed
from bcp_tpu_torch.parallel import mesh

import torch_parallel_ranks as ranks
from test_torch_pancreas_ops import jax_fixed_starts
from test_torch_steps import _f64, _np
from test_torch_train_ops import jax_cuboid_starts
from torch_port_helpers import unet_chns

W = 2
NF = 4
#: per-rank configs: the reference batch (2 + 2 labelled, 2 + 2 unlabelled)
KW = {
    "la": dict(labelnum=4, n_filters=NF, patch_size=(16, 16, 16),
               batch_size=8, labeled_bs=4, compute_dtype="float32"),
    "acdc": dict(labelnum=1, n_filters=NF, patch_size=(32, 32),
                 batch_size=8, labeled_bs=4, compute_dtype="float32"),
    "pancreas": dict(n_filters=NF, patch_size=(16, 16, 16), mask_patch=8,
                     batch_size=8, labeled_bs=4, compute_dtype="float32"),
}
JAX_CONFIGS = {"la": jax_la_config, "acdc": jax_acdc_config,
               "pancreas": jax_pancreas_config}
NET = {"la": "VNet", "acdc": "unet", "pancreas": "VNet_pancreas"}
CASES = ["la_pre", "la_self", "acdc_self", "pancreas_self"]


def _global_batch(variant, seed):
    """Blob images, W * 2 rows a stream, channels-last as the JAX feed's."""
    rng = np.random.default_rng(seed)
    S = KW[variant]["patch_size"]
    n = 2 * W
    g = np.stack(np.meshgrid(*[np.arange(s) for s in S], indexing="ij"))
    lo, hi = 0.25 * S[0], 0.75 * S[0]
    out = {}
    for k in ("a", "b", "ua", "ub"):
        lab = np.zeros((n, *S), np.uint8)
        for c in range(1, 4 if variant == "acdc" else 2):
            ctr = rng.uniform(lo, hi, size=(n, len(S)) + (1,) * len(S))
            lab[((g[None] - ctr) ** 2).sum(1) <= rng.uniform(
                S[0], 2.5 * S[0])] = c
        img = (rng.normal(0, 0.3, (n, *S)) + 0.5 * lab)[..., None]
        if k.startswith("u"):
            out[f"uimg_{k[1]}"] = img
        else:
            out[f"img_{k}"], out[f"lab_{k}"] = img, lab
    return out


def _port_layout(batch):
    return {k: np.ascontiguousarray(np.moveaxis(v, -1, 1))
            if k.startswith(("img", "uimg")) else v
            for k, v in batch.items()}


def _flax(variant):
    if variant == "acdc":
        return FlaxUNet2D(n_classes=4, feature_chns=unet_chns(NF),
                          dropout=(0.0,) * 5)
    return FlaxVNet3D(n_classes=2, n_filters=NF, has_dropout=False,
                      normalization="instancenorm" if variant == "pancreas"
                      else "batchnorm")


def _sd(variant, params, stats):
    v = {"params": params}
    if stats:
        v["batch_stats"] = stats
    return {k: t.numpy() for k, t in convert.state_dict_from_flax(
        _np(v), NET[variant], dtype=np.float64).items()}


def _jax_dp_step(case):
    """(start state_dict, global port batch, port mask, JAX state after,
    JAX metrics) of the JAX package's step on a two-device mesh."""
    variant, stage = case.split("_")
    kw = dict(KW[variant], batch_size=8 * W, labeled_bs=4 * W)
    jcfg = JAX_CONFIGS[variant](**kw)
    fmodel = _flax(variant)
    tx = jax_build_optimizer(jcfg, stage)
    st = jax_init_state(fmodel, jcfg, jax.random.PRNGKey(3), tx)
    params, stats = _f64(st.params), _f64(st.batch_stats)
    st = st.replace(params=params, batch_stats=stats,
                    teacher_params=_f64(params),
                    teacher_batch_stats=_f64(stats),
                    opt_state=tx.init(params))
    start = _sd(variant, params, stats)
    batch = {k: v.astype(np.float64) if v.dtype != np.uint8 else v
             for k, v in _global_batch(variant, 4).items()}
    key = jax.random.PRNGKey(5)
    S = KW[variant]["patch_size"]
    if stage == "pre":
        mask_key = jax.random.split(key)[0]
        fn = make_pretrain_step(fmodel, tx, jcfg)
        batch = {k: v for k, v in batch.items() if not k.startswith("u")}
    else:
        mask_key = jax.random.split(key, 3)[0]
        fn = make_selftrain_step(fmodel, tx, jcfg)
    if variant == "pancreas":
        cube = KW[variant]["mask_patch"]
        mask = cuboid_mask_fixed(S, jax_fixed_starts(mask_key, S, cube),
                                 cube)
    else:
        mask = cuboid_mask(S, jax_cuboid_starts(mask_key, S))
    dp = make_mesh(W)
    new, metrics = fn(replicate_state(st, dp), shard_batch(batch, dp), key)
    return (start, _port_layout(batch), mask.numpy(), _np(new),
            {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def runs():
    jax.config.update("jax_enable_x64", True)
    try:
        want = {case: _jax_dp_step(case) for case in CASES}
    finally:
        jax.config.update("jax_enable_x64", False)
    tasks = {case: ("step", (case.split("_")[0], case.split("_")[1],
                             want[case][0], want[case][1], want[case][2],
                             KW[case.split("_")[0]]))
             for case in CASES}
    two = mesh.launch(ranks.run_tasks, W, "cpu", tasks)
    one = ranks.run_tasks(tasks)
    return want, {c: v[0] for c, v in one.items()}, two


def _close(got, want, what, rel, floor):
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= max(rel * scale, floor), f"{what}: err {err} scale {scale}"


def _stats(k):
    return k.endswith(("running_mean", "running_var"))


def _hold(got, want, start, rel, floor, counts=True):
    """Student / teacher state_dicts: updates as deltas, running statistics
    as values, ``num_batches_tracked`` equal (``counts``; the JAX package
    keeps none)."""
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert not counts or int(v) == int(want[k]), k
        elif _stats(k):
            _close(v, want[k], k, rel, floor)
        else:
            _close(v - start[k], want[k] - start[k], k, rel, floor)


@pytest.mark.parametrize("case", CASES)
def test_ranks_end_in_the_same_state(runs, case):
    _, _, two = runs
    a, b = two[case]
    assert a[0] == b[0]
    for part in (1, 2, 3):
        assert sorted(a[part]) == sorted(b[part])
        for k, v in a[part].items():
            np.testing.assert_array_equal(v, b[part][k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_process_on_the_global_batch(runs, case):
    want, one, two = runs
    start = want[case][0]
    got = two[case][0]
    for k, v in one[case][0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=1e-10, err_msg=k)
    _hold(got[1], one[case][1], start, 1e-10, 1e-12)
    _hold(got[2], one[case][2], start, 1e-10, 1e-12)
    assert sorted(got[3]) == sorted(one[case][3]) and got[3]
    for k, v in one[case][3].items():
        _close(got[3][k], v, k, 1e-10, 1e-12)


def _jax_opt(variant, opt_state):
    """{port key suffix: optax tree}: SGD's momentum trace, Adam's
    moments."""
    for part in opt_state:
        if hasattr(part, "trace"):
            return {"momentum_buffer": part.trace}
        if hasattr(part, "mu"):
            return {"exp_avg": part.mu, "exp_avg_sq": part.nu}
    raise AssertionError("no optimizer state in the optax state")


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_the_jax_data_parallel_step(runs, case):
    want, _, two = runs
    variant = case.split("_")[0]
    start, _, _, new, jmetrics = want[case]
    got = two[case][0]
    assert set(got[0]) == set(jmetrics)
    for k, v in got[0].items():
        np.testing.assert_allclose(v, jmetrics[k], rtol=1e-9, err_msg=k)
    _hold(got[1], _sd(variant, new.params, new.batch_stats), start, 1e-3,
          1e-9, counts=False)
    teacher = _sd(variant, new.teacher_params, new.teacher_batch_stats)
    for k, v in got[2].items():
        if k.endswith("num_batches_tracked"):
            continue
        if _stats(k):
            _close(v, teacher[k], k, 1e-9, 1e-9)
        else:
            _close(v - start[k], teacher[k] - start[k], k, 1e-3, 1e-9)
    for suffix, tree in _jax_opt(variant, new.opt_state).items():
        ref = _sd(variant, tree, new.batch_stats)
        for name in ref:
            if _stats(name) or name.endswith("num_batches_tracked"):
                continue
            _close(got[3][f"{name}.{suffix}"], ref[name], name, 1e-3, 1e-9)
