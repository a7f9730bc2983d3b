"""A zoo net's data-parallel update: UNet3D (``ZOO``'s narrow widths, LA
steps at 16^3) over two gloo ranks against the same update in one process
on the global batch, pre-train and self-train, in f64 with its channel
dropout on (one generator, drawn over the global batch, each rank keeping
its rows). Its BatchNorms normalise the concat batch as one over both
ranks (the JAX net has no ``bn_groups``), and the dropouts' draws follow
the concat's two sub-batches. The tolerances of
``tests/test_torch_parallel_steps.py``: every update within 1e-10 of the
one-process update's largest magnitude, the running statistics within
1e-10 of theirs, ``num_batches_tracked`` equal; the ranks end in the
same state, bit for bit. The losses to rtol 1e-6: UNet3D's heads come
out in f32 (as the JAX package casts them), so its losses are f32
sums."""

import numpy as np
import pytest
import torch

from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.parallel import mesh

import torch_parallel_ranks as ranks
from test_torch_parallel_steps import (W, _close, _global_batch, _hold,
                                       _port_layout)
from torch_port_helpers import ZOO

NET = "unet_3D"
KW = ZOO["unet_3D_narrow"][0]
CFG = dict(labelnum=4, patch_size=(16, 16, 16), batch_size=8, labeled_bs=4,
           compute_dtype="float32")


@pytest.fixture(scope="module")
def runs():
    return two_and_one()


def two_and_one():
    """(start, the one-process results, the two ranks' results) of both
    stages' updates."""
    torch.manual_seed(0)
    start = {k: v.double().numpy() for k, v in create_model(
        NET, 2, mode="train", device="cpu", **KW).state_dict().items()}
    batch = _port_layout(_global_batch("la", 4))
    rng = np.random.default_rng(2)
    mask = np.ones(CFG["patch_size"], np.int64)
    mask[tuple(slice(int(s), int(s) + 10)
               for s in rng.integers(0, 6, 3))] = 0
    tasks = {}
    for stage in ("pre", "self"):
        b = batch if stage == "self" else {
            k: v for k, v in batch.items() if not k.startswith("u")}
        tasks[stage] = ("zoo_step", (NET, KW, stage, start, b, mask, CFG,
                                     7))
    two = mesh.launch(ranks.run_tasks, W, "cpu", tasks)
    one = ranks.run_tasks(tasks)
    return start, {c: v[0] for c, v in one.items()}, two


@pytest.mark.parametrize("stage", ["pre", "self"])
def test_zoo_ranks_end_in_the_same_state(runs, stage):
    _, _, two = runs
    a, b = two[stage]
    assert a[0] == b[0]
    for part in (1, 2, 3):
        assert sorted(a[part]) == sorted(b[part])
        for k, v in a[part].items():
            np.testing.assert_array_equal(v, b[part][k], err_msg=k)


@pytest.mark.parametrize("stage", ["pre", "self"])
def test_zoo_two_ranks_equal_one_process(runs, stage):
    start, one, two = runs
    got, want = two[stage][0], one[stage]
    for k, v in want[0].items():
        # UNet3D's heads come out in f32: the losses are f32 sums, summed
        # over the ranks in another order
        np.testing.assert_allclose(got[0][k], v, rtol=1e-6, err_msg=k)
    _hold(got[1], want[1], start, 1e-10, 1e-12)
    _hold(got[2], want[2], start, 1e-10, 1e-12)
    assert sorted(got[3]) == sorted(want[3]) and got[3]
    for k, v in want[3].items():
        _close(got[3][k], v, k, 1e-10, 1e-12)
    # one BatchNorm group a forward: the concat batch is one batch
    counts = {int(v) for k, v in got[1].items()
              if k.endswith("num_batches_tracked")}
    assert counts == {1}
