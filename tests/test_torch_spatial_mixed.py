"""Data parallelism and spatial partitioning together, on the CPU: a world
of four gloo ranks as two data indices by two space indices (N = 4, S =
2), then as one by four (S = 4: the V-Net's 16 planes give slabs of 4, 2
and 1, so its levels 3 and 4 run replicated), against one process on the
global batch. Float64, n_filters 4, 16^3 patches (ACDC 32x32).

- The three nets' train-mode forwards and backwards and the NMS, as
  ``test_torch_spatial.py`` holds them at N = S = 2.
- Instance norm takes each sample's statistics over its space group only
  (a world sum would mix the two data indices' samples); the losses:
  masked Dice per sample (its sums over the space group before the
  ratio), the ratio-of-sums losses and the mean CE unchanged.
- One update of each pipeline at N = 4, S = 2 (LA pre and self, ACDC
  self, pancreas self) and of LA and pancreas at S = 4: losses to rtol
  1e-10, updates within 1e-10 of the one-process update's largest per
  tensor, a 1e-12 floor (SGD) or 1e-10 (Adam; the test says why),
  running statistics to 1e-10, ``num_batches_tracked`` equal; every rank
  ends in the same state bit for bit."""

import numpy as np
import pytest

from bcp_tpu_torch.parallel import mesh

import torch_spatial_ranks as sr
import torch_port_helpers  # noqa: F401  (one torch thread a process)
from test_torch_spatial import check_forward, check_nms, net_tasks

#: the updates of each split of the four ranks: S -> cases
CASES = {2: ["la_pre", "la_self", "acdc_self", "pancreas_self"],
         4: ["la_self", "pancreas_self"]}


def _tasks(sp):
    t = net_tasks(4, sp)
    for case in CASES[sp]:
        t[f"step_{case}"] = sr.step_task(case, 4, sp, seed=4 + sp)
    if sp == 2:
        rng = np.random.default_rng(42)
        x = rng.normal(size=(4, 3, 8, 6, 5))
        t["instance_norm"] = ("instance_norm", 2,
                              (x, rng.normal(size=x.shape)))
        t["losses"] = ("loss_parts", 2, (
            rng.normal(size=(4, 3, 8, 6, 5)),
            rng.integers(0, 3, (4, 8, 6, 5)).astype(np.int64),
            (rng.random((4, 8, 6, 5)) < 0.7).astype(np.float64), 3))
    return t


@pytest.fixture(scope="module")
def runs():
    """{S: (the four ranks' results, the one process's)}: one world, S = 2
    then S = 4."""
    tasks = {sp: _tasks(sp) for sp in CASES}
    world = mesh.launch(sr.run_tasks, 4, "cpu", {
        f"{k}@{sp}": v for sp, t in tasks.items() for k, v in t.items()})
    return {sp: ({k.split("@")[0]: v for k, v in world.items()
                  if k.endswith(f"@{sp}")}, sr.run_tasks(t))
            for sp, t in tasks.items()}


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("kind", ["la", "pancreas", "acdc"])
def test_train_forward_and_backward_equal_one_process(runs, sp, kind):
    check_forward(*runs[sp], 4, sp, kind)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("variant", ["la", "pancreas", "acdc"])
def test_nms_on_gathered_masks_equals_one_process(runs, sp, variant):
    check_nms(*runs[sp], 4, sp, variant)


def test_instance_norm_takes_a_samples_space_group_only(runs):
    wr, one = runs[2]
    y, dx = one["instance_norm"][0]
    for r, got in enumerate(wr["instance_norm"]):
        sr.close(got[0], sr.part(y, r, 4, 2, 2), "y")
        sr.close(got[1], sr.part(dx, r, 4, 2, 2), "dx")


def test_masked_dice_per_sample_and_the_ratio_of_sums(runs):
    wr, one = runs[2]
    want, grad = one["losses"][0]
    for r, (vals, g) in enumerate(wr["losses"]):
        for k, v in want.items():
            assert vals[k] == pytest.approx(v, rel=1e-12), k
        sr.close(g, sr.part(grad, r, 4, 2, 2), "dL/dlogits")


@pytest.mark.parametrize("sp,case", [(sp, c) for sp in CASES
                                     for c in CASES[sp]])
def test_step_equals_one_process_on_the_global_batch(runs, sp, case):
    wr, one = runs[sp]
    want = one[f"step_{case}"][0]
    ranks = wr[f"step_{case}"]
    for a in ranks[1:]:
        sr.same(a, ranks[0])
    got = ranks[0]
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=1e-10, err_msg=k)
    # Adam (pancreas) moves a conv bias in front of an instance norm,
    # whose gradient is 0 in exact arithmetic, by about lr * 0.1 * g / eps
    # for its f64 rounding noise g: ~1e-15 here, where the slabs split
    # every volume sum into 4-8 parts (two data ranks: ~1e-17), so ~1e-11
    # moves; SGD keeps the 1e-12 floor
    floor = 1e-10 if case.startswith("pancreas") else 1e-12
    start = sr.state_dict(case.split("_")[0], 1)
    sr.hold(got[1], want[1], start, floor=floor)
    sr.hold(got[2], want[2], start, floor=floor)
    assert sorted(got[3]) == sorted(want[3]) and got[3]
    for k, v in want[3].items():
        sr.close(got[3][k], v, k, floor=floor)
