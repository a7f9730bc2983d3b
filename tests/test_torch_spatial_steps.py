"""One spatially partitioned update of each pipeline over two gloo ranks
(``--num_devices 2 --sp_devices 2``: one data index, each volume's x extent
split in two) against the same update in one process on the whole volumes,
and against the JAX package's step on ``make_mesh(2, sp=2)`` of the virtual
CPU devices (as ``tests/test_parallel.py::test_sp_selftrain_step_matches_
loss`` builds it). Also under S = 2: K = 2 dispatch groups against K = 1,
and remat against the plain model.

The cases: the pre-train and self-train updates of LA (the V-Net with
grouped BatchNorm: its 16 planes give slabs of 8, 4, 2 and 1, so the
bottom level runs replicated), ACDC (the U-Net, per-class Dice, the
full-state EMA) and pancreas (instance norm, Adam). The global batch is
the reference batch (2 + 2 labelled, 2 + 2 unlabelled rows). Dropout is off;
the JAX step's own mask draws go to the port. Float64 throughout.

- Two ranks against one process: the losses to rtol 1e-10; every update
  (parameters, teacher, optimizer state) within 1e-10 of the one-process
  update's largest magnitude per tensor, with a 1e-12 floor (SGD) or 1e-10
  (Adam: ``test_torch_spatial_mixed.py`` says why); the running statistics
  within 1e-10; ``num_batches_tracked`` equal. The ranks end in the same
  state bit for bit.
- Two ranks against the JAX package's ``sp=2`` step: the tolerances of
  ``test_torch_steps.py``: losses to rtol 1e-9, updates within 1e-3 of the
  JAX update's largest magnitude, running statistics to 1e-9.
- K = 2 (``GraphStep``'s static-buffer bodies) equals K = 1 bit for bit
  over four LA self-train iterations with dropout on; remat equals the
  plain model bit for bit over two LA and two pancreas self-train updates
  (channel dropout drawn by the trainer's generator).

The ranks run in one spawned world for every case."""

import jax
import numpy as np
import pytest

from bcp_tpu.parallel import make_mesh, replicate_state, shard_batch
from bcp_tpu.train.state import build_optimizer as jax_build_optimizer
from bcp_tpu.train.state import init_state as jax_init_state
from bcp_tpu.train.steps import make_pretrain_step, make_selftrain_step
from bcp_tpu_torch.ops.masks import cuboid_mask, cuboid_mask_fixed
from bcp_tpu_torch.parallel import mesh

import torch_spatial_ranks as sr
from test_torch_pancreas_ops import jax_fixed_starts
from test_torch_parallel_steps import JAX_CONFIGS, _flax, _jax_opt, _sd
from test_torch_steps import _f64, _np
from test_torch_train_ops import jax_cuboid_starts

CASES = ["la_pre", "la_self", "acdc_pre", "acdc_self", "pancreas_pre",
         "pancreas_self"]


def _jax_sp_step(case):
    """(start state_dict, global port batch, port mask, JAX state after,
    JAX metrics) of the JAX package's step on ``make_mesh(2, sp=2)``."""
    variant, stage = case.split("_")
    jcfg = JAX_CONFIGS[variant](**sr.TINY[variant])
    fmodel = _flax(variant)
    tx = jax_build_optimizer(jcfg, stage)
    st = jax_init_state(fmodel, jcfg, jax.random.PRNGKey(3), tx)
    params, stats = _f64(st.params), _f64(st.batch_stats)
    st = st.replace(params=params, batch_stats=stats,
                    teacher_params=_f64(params),
                    teacher_batch_stats=_f64(stats),
                    opt_state=tx.init(params))
    start = _sd(variant, params, stats)
    port = sr.blob_batch(variant, 2, sr.TINY[variant]["patch_size"], 4)
    if stage == "pre":
        port = {k: v for k, v in port.items() if not k.startswith("u")}
    # the JAX feed's layout: channels last
    batch = {k: np.moveaxis(v, 1, -1) if k.startswith(("img", "uimg"))
             else v for k, v in port.items()}
    key = jax.random.PRNGKey(5)
    S = sr.TINY[variant]["patch_size"]
    if stage == "pre":
        mask_key = jax.random.split(key)[0]
        fn = make_pretrain_step(fmodel, tx, jcfg)
    else:
        mask_key = jax.random.split(key, 3)[0]
        fn = make_selftrain_step(fmodel, tx, jcfg)
    if variant == "pancreas":
        cube = sr.TINY[variant]["mask_patch"]
        mask = cuboid_mask_fixed(S, jax_fixed_starts(mask_key, S, cube),
                                 cube)
    else:
        mask = cuboid_mask(S, jax_cuboid_starts(mask_key, S))
    sp = make_mesh(2, sp=2)
    new, metrics = fn(replicate_state(st, sp), shard_batch(batch, sp), key)
    return (start, port, mask.numpy(), _np(new),
            {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def runs():
    jax.config.update("jax_enable_x64", True)
    try:
        want = {case: _jax_sp_step(case) for case in CASES}
    finally:
        jax.config.update("jax_enable_x64", False)
    tasks = {case: ("step", 2, (case.split("_")[0], case.split("_")[1],
                                *want[case][:3], sr.TINY[case.split("_")[0]]))
             for case in CASES}
    la = [sr.blob_batch("la", 2, sr.P3, seed=20 + i) for i in range(4)]
    kw = dict(sr.TINY["la"], batch_size=4, labeled_bs=2)
    extra = {"k1": ("dispatch", 2, (kw, la, 1)),
             "k2": ("dispatch", 2, (kw, la, 2))}
    for variant in ("la", "pancreas"):
        b = [sr.blob_batch(variant, 2, sr.P3, seed=30 + i) for i in range(2)]
        extra[f"plain_{variant}"] = ("remat_steps", 2, (variant, b, False))
        extra[f"remat_{variant}"] = ("remat_steps", 2, (variant, b, True))
    two = mesh.launch(sr.run_tasks, 2, "cpu", dict(tasks, **extra))
    one = sr.run_tasks(tasks)
    return want, {c: v[0] for c, v in one.items()}, two


def _floor(case):
    return 1e-10 if case.startswith("pancreas") else 1e-12


@pytest.mark.parametrize("case", CASES)
def test_ranks_end_in_the_same_state(runs, case):
    a, b = runs[2][case]
    sr.same(a, b)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_process_on_the_whole_volumes(runs, case):
    want, one, two = runs
    start = want[case][0]
    got = two[case][0]
    for k, v in one[case][0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=1e-10, err_msg=k)
    sr.hold(got[1], one[case][1], start, floor=_floor(case))
    sr.hold(got[2], one[case][2], start, floor=_floor(case))
    assert sorted(got[3]) == sorted(one[case][3]) and got[3]
    for k, v in one[case][3].items():
        sr.close(got[3][k], v, k, floor=_floor(case))


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_the_jax_sp_step(runs, case):
    want, _, two = runs
    variant = case.split("_")[0]
    start, _, _, new, jmetrics = want[case]
    got = two[case][0]
    assert set(got[0]) == set(jmetrics)
    for k, v in got[0].items():
        np.testing.assert_allclose(v, jmetrics[k], rtol=1e-9, err_msg=k)
    sr.hold(got[1], _sd(variant, new.params, new.batch_stats), start, 1e-3,
            1e-9, counts=False)
    teacher = _sd(variant, new.teacher_params, new.teacher_batch_stats)
    for k, v in got[2].items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            sr.close(v, teacher[k], k, 1e-9, 1e-9)
        else:
            sr.close(v - start[k], teacher[k] - start[k], k, 1e-3, 1e-9)
    for suffix, tree in _jax_opt(variant, new.opt_state).items():
        ref = _sd(variant, tree, new.batch_stats)
        for name in ref:
            if name.endswith(("running_mean", "running_var",
                              "num_batches_tracked")):
                continue
            sr.close(got[3][f"{name}.{suffix}"], ref[name], name, 1e-3, 1e-9)


def test_k2_equals_k1_under_a_space_split(runs):
    two = runs[2]
    for a, b in zip(two["k2"], two["k1"]):
        sr.same(a, b)


@pytest.mark.parametrize("variant", ["la", "pancreas"])
def test_remat_under_a_space_split_is_the_plain_update(runs, variant):
    two = runs[2]
    for a, b in zip(two[f"remat_{variant}"], two[f"plain_{variant}"]):
        sr.same(a, b)
