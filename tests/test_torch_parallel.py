"""The port's data parallelism (``parallel.mesh``) on the CPU: two gloo
ranks against one process on the global batch, and the feeder at
``data_scale=2`` against the JAX package's.

- The two reductions on a toy function: the loss sums (gradient passed
  through) and a BatchNorm-like statistic (gradient summed over the ranks).
- Grouped ``TorchBatchNorm`` in train mode: output, input gradient,
  parameter gradients (summed by ``all_reduce_grads``), running statistics
  and ``num_batches_tracked``.
- ``dice_loss_per_class``, ``masked_cross_entropy``, ``masked_dice_loss``
  and ``cross_entropy_mean`` with masks of unequal density per rank.
- Four LA self-train iterations with dropout on: K = 1 eager steps and K =
  2 groups through ``GraphStep``'s bodies (the keep masks drawn ahead for
  the global batch), bit for bit under two ranks; both against one process
  on the global batch in f64.
- ``SlidingWindowEvaluator`` (each rank's windows of every chunk, one
  all-reduce of the score map) and ``Slice2DEvaluator`` (each rank's block
  of slices, labels gathered): scores to 1e-4, labels equal.

Every two-rank run here shares one spawned world (a module fixture)."""

import numpy as np
import pytest
import torch

from bcp_tpu.config import acdc_config as jax_acdc_config
from bcp_tpu.config import la_config as jax_la_config
from bcp_tpu.config import pancreas_config as jax_pancreas_config
from bcp_tpu.data import feed as jax_feed
from bcp_tpu.data import synthetic as jax_synthetic
from bcp_tpu.data.feed import BCPBatchFeeder as JaxFeeder
from bcp_tpu_torch.config import acdc_config, la_config, pancreas_config
from bcp_tpu_torch.data import feed
from bcp_tpu_torch.data.datasets import (ACDCDataset, LAHeartDataset,
                                         PancreasDataset)
from bcp_tpu_torch.data.feed import BCPBatchFeeder
from bcp_tpu_torch.models import UNet2D, VNet3D
from bcp_tpu_torch.parallel import mesh

import torch_parallel_ranks as ranks
from torch_port_helpers import unet_chns

W = 2
NF = 4
#: the dispatch runs' per-rank config: the reference LA batch at 16^3
DISPATCH_KW = dict(labelnum=4, n_filters=NF, patch_size=(16, 16, 16),
                   compute_dtype="float32")


def _merge(parts, groups=1):
    """The global rows from each rank's rows (layout group, rank, row)."""
    p = np.stack(parts)
    n = p.shape[1]
    p = p.reshape(len(parts), groups, n // groups, *p.shape[2:])
    return np.swapaxes(p, 0, 1).reshape(-1, *p.shape[3:])


def _inputs():
    rng = np.random.default_rng(0)
    out = {"toy": (rng.normal(size=(4, 3)),)}
    bx = rng.normal(1.0, 2.0, size=(8, 3, 4, 4, 4))
    out["bn"] = (bx, rng.normal(size=bx.shape), 2)
    logits = rng.normal(size=(4, 3, 6, 6))
    target = rng.integers(0, 3, (4, 6, 6))
    # rank 0's rows mostly in the mask, rank 1's mostly out of it
    mask = np.concatenate([rng.random((2, 6, 6)) < 0.9,
                           rng.random((2, 6, 6)) < 0.15]).astype(np.int64)
    out["loss"] = (logits, target, mask, 3)
    # the dispatch runs: four iterations' global batches
    S = DISPATCH_KW["patch_size"]
    out["batches"] = [{
        **{f"img_{k}": rng.normal(size=(2 * W, 1, *S)) for k in "ab"},
        **{f"uimg_{k}": rng.normal(0.5, 1.0, size=(2 * W, 1, *S))
           for k in "ab"},
        **{f"lab_{k}": rng.integers(0, 2, (2 * W, *S)).astype(np.uint8)
           for k in "ab"}} for _ in range(4)]
    # the evaluators: seeded nets, one volume each
    torch.manual_seed(1)
    vnet = VNet3D(n_classes=2, n_filters=NF).state_dict()
    unet = UNet2D(feature_chns=unet_chns(NF),
                  dropout=(0.0,) * 5).state_dict()
    out["sliding"] = (vnet, rng.normal(size=(30, 26, 22)).astype(np.float32),
                      NF, (16, 16, 16), (6, 4), 2)
    out["slices"] = (unet, rng.normal(size=(5, 40, 36)).astype(np.float32),
                     NF, (32, 32))
    return out


@pytest.fixture(scope="module")
def runs():
    x = _inputs()
    tasks = {
        "toy": ("toy", x["toy"]),
        "bn": ("batchnorm", x["bn"]),
        "loss": ("loss_parts", x["loss"]),
        "k1": ("dispatch", (DISPATCH_KW, x["batches"], 1)),
        "k2": ("dispatch", (DISPATCH_KW, x["batches"], 2)),
        "sliding": ("sliding_window", x["sliding"]),
        "slices": ("slices", x["slices"]),
    }
    two = mesh.launch(ranks.run_tasks, W, "cpu", tasks)
    one = ranks.run_tasks({k: v for k, v in tasks.items() if k != "k2"})
    return {k: v[0] for k, v in one.items()}, two


def test_world_helpers_outside_a_world():
    """Outside a world every reduction is the identity, the rows are the
    whole batch and the counts are one rank's."""
    assert not mesh.active() and mesh.world_size() == 1 and mesh.is_main()
    t = torch.arange(6.0).reshape(3, 2)
    for fn in (mesh.sum_ranks, mesh.mean_ranks, mesh.mean_statistics,
               mesh.shard_rows, mesh.gather_rows, mesh.all_reduce_):
        assert fn(t) is t
    assert mesh.rank_rows(t, 3) is t and mesh.broadcast_object(5) == 5
    assert mesh.resolve_count(1, "cuda") == 1
    assert mesh.resolve_count(3, "cpu") == 3
    with pytest.raises(ValueError, match="visible"):
        mesh.resolve_count(torch.cuda.device_count() + 2, "cuda")


def test_toy_reductions_match_one_process(runs):
    one, two = runs
    for loss, _ in two["toy"]:
        np.testing.assert_allclose(loss, one["toy"][0], rtol=1e-13)
    np.testing.assert_allclose(_merge([g for _, g in two["toy"]]),
                               one["toy"][1], rtol=1e-12, atol=1e-13)


def test_grouped_batchnorm_matches_one_process(runs):
    """Output and input gradient (global rows laid out group by group),
    then, equal on both ranks, the running statistics, the summed weight
    and bias gradients and one ``num_batches_tracked`` a group."""
    one, two = runs
    for i in (0, 1):
        np.testing.assert_allclose(_merge([r[i] for r in two["bn"]], 2),
                                   one["bn"][i], rtol=1e-12, atol=1e-13)
    for r in two["bn"]:
        for i in (2, 3, 5, 6):
            np.testing.assert_allclose(r[i], one["bn"][i], rtol=1e-12,
                                       atol=1e-13)
        assert r[4] == one["bn"][4] == 2


def test_losses_with_unequal_masks_match_one_process(runs):
    one, two = runs
    for values, _ in two["loss"]:
        assert values.keys() == one["loss"][0].keys()
        for k, v in values.items():
            np.testing.assert_allclose(v, one["loss"][0][k], rtol=1e-13,
                                       err_msg=k)
    np.testing.assert_allclose(_merge([g for _, g in two["loss"]]),
                               one["loss"][1], rtol=1e-12, atol=1e-15)


def _assert_equal_states(a, b):
    assert a[0] == b[0]
    for part in (1, 2, 3):
        assert sorted(a[part]) == sorted(b[part])
        for k, v in a[part].items():
            np.testing.assert_array_equal(v, b[part][k], err_msg=k)


def test_k2_groups_equal_k1_steps_under_two_ranks(runs):
    """Four self-train iterations under two ranks: groups of two through
    the static-buffer bodies equal four eager steps bit for bit (losses,
    student, teacher, momentum buffers), and the two ranks agree."""
    _, two = runs
    for r in range(W):
        _assert_equal_states(two["k2"][r], two["k1"][r])
    _assert_equal_states(two["k1"][0], two["k1"][1])


def test_two_rank_steps_with_dropout_match_one_process(runs):
    """The same four eager iterations in one process on the global batch:
    each rank's channel-dropout keep masks are its rows of the global
    draw, so the runs agree to f64 rounding."""
    one, two = runs
    got, want = two["k1"][0], one["k1"]
    for g, w in zip(got[0], want[0]):
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=1e-10, err_msg=k)
    for part in (1, 2, 3):
        for k, v in want[part].items():
            if k.endswith("num_batches_tracked"):
                assert int(got[part][k]) == int(v), k
                continue
            scale = max(np.abs(v).max(), 1e-12)
            assert np.abs(got[part][k] - v).max() <= 1e-10 * scale, k


def test_sliding_window_evaluator_over_two_ranks(runs):
    one, two = runs
    label, score = one["sliding"]
    for got_label, got_score in two["sliding"]:
        np.testing.assert_allclose(got_score, score, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got_label, label)


def test_slice_evaluator_over_two_ranks(runs):
    """Five slices padded to six, three a rank."""
    one, two = runs
    for labels in two["slices"]:
        np.testing.assert_array_equal(labels, one["slices"])


# ---------------------------------------------------------------------------
# the feeder at data_scale=2


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    la = tmp_path_factory.mktemp("la_dp")
    jax_synthetic.make_la_dataset(str(la), n_train=16, n_test=1,
                                  shape=(22, 20, 18), seed=11)
    acdc = tmp_path_factory.mktemp("acdc_dp")
    jax_synthetic.make_acdc_dataset(str(acdc), n_train_slices=20, n_val=2,
                                    slice_shape=(40, 36), vol_depth=3,
                                    seed=11)
    panc = jax_synthetic.make_pancreas_dataset(
        str(tmp_path_factory.mktemp("pancreas_dp")), n_lab=6, n_unlab=8,
        n_test=2, shape=(20, 14, 18), seed=5)
    return {"la": str(la), "acdc": str(acdc), "pancreas": panc}


def _configs(variant, root):
    if variant == "la":
        kw = dict(root_path=root, labelnum=8, patch_size=(16, 16, 12))
        return (jax_la_config(**kw), la_config(**kw),
                LAHeartDataset(root, "train", cache=True))
    if variant == "acdc":
        kw = dict(root_path=root, labelnum=1, patch_size=(32, 32),
                  batch_size=8, labeled_bs=4)
        return (jax_acdc_config(**kw), acdc_config(**kw),
                ACDCDataset(root, "train", cache=True))
    kw = dict(root_path=root, patch_size=(16, 16, 16))
    return (jax_pancreas_config(20, **kw), pancreas_config(20, **kw),
            (PancreasDataset(root, "train_lab"),
             PancreasDataset(root, "train_unlab")))


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("variant", ["la", "acdc", "pancreas"])
def test_feed_at_data_scale_2_equals_jax_and_splits_by_rank(
        roots, monkeypatch, variant, K):
    """The global batches bit for bit the JAX feeder's at ``data_scale=2``
    (every stream twice as wide, the epoch twice as short; K-stacked in the
    K = 1 order), and rank 0's rows then rank 1's of each stream of the
    feeders with ``rank`` are those global batches."""
    monkeypatch.setitem(jax_feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    monkeypatch.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    jcfg, cfg, data = _configs(variant, roots[variant])
    jcfg = jcfg.replace(compute_dtype="float32", device_data_cache=False)
    cfg = cfg.replace(compute_dtype="float32", device_data_cache=False)
    want_feed = JaxFeeder(jcfg, "self", data_scale=W, stack=K)
    feeds = [BCPBatchFeeder(cfg, "self", data, device="cpu", stack=K,
                            data_scale=W, rank=r) for r in (None, 0, 1)]
    try:
        assert feeds[0].steps_per_epoch == want_feed.steps_per_epoch
        for _ in range(3):
            want = {k: np.asarray(v) for k, v in next(want_feed).items()
                    if not k.startswith("ulab")}
            got, r0, r1 = (next(f) for f in feeds)
            assert sorted(got) == sorted(want) == sorted(r0)
            axis = 1 if K > 1 else 0
            for k, v in got.items():
                w = want[k]
                if k.startswith(("img", "uimg")):
                    w = np.moveaxis(w, -1, axis + 1)
                np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
                np.testing.assert_array_equal(
                    torch.cat([r0[k], r1[k]], dim=axis).numpy(), v.numpy(),
                    err_msg=k)
    finally:
        want_feed.close()
        for f in feeds:
            f.close()


def test_device_store_is_refused_with_several_ranks(roots):
    _, cfg, data = _configs("la", roots["la"])
    with pytest.raises(ValueError, match="single-device"):
        BCPBatchFeeder(cfg.replace(device_data_cache=True), "pre", data,
                       device="cpu", data_scale=2, rank=0)
