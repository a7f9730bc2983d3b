"""Spatial partitioning (``--sp_devices``) in the port, on the CPU: a world
of two gloo ranks that splits each volume's x extent in two
(``parallel.mesh.set_space``: one data index, two space indices), each rank
on its x slab, against one process on the whole volumes; and the
pad-and-crop conv in one process. Float64, n_filters 4, 16^3 patches
(ACDC 32x32).

- The collectives: the halo'd slab holds the whole volume's planes (zeros
  at its ends), the gather the whole volume, the space sum the whole
  volume's; ``torch.autograd.gradcheck`` holds each backward (the halo's
  send-back, the gather's reduce-scatter, the sum's all-reduce).
- The pad-and-crop conv: kernel B's plain version (forward, B-as-dx, C),
  D's, and block_one's ``F.conv3d`` (VALID in x), on the halo-padded slabs
  of ``mesh.halo_slabs``, equal the whole-volume conv slab by slab, the
  slabs' dx folded back by ``mesh.fold_slabs``, to 1e-12.
- The three nets' train-mode forwards and backwards: logits, loss and
  running statistics to 1e-10, gradients within 1e-9 of each tensor's
  largest (a floor of 1e-13 of the net's largest gradient; the test says
  why); the level whose down step gathers.
- The NMS on masks gathered over the space group.

A world of four ranks (N = 4 at S = 2 and S = 4) is
``test_torch_spatial_mixed.py``; the steps against the JAX package's
``sp=2`` step, K = 2 and remat ``test_torch_spatial_steps.py``; the CLI
``test_torch_spatial_cli.py``."""

import numpy as np
import pytest
import torch

from bcp_tpu_torch.ops.conv3d import Conv3x3x3Function
from bcp_tpu_torch.parallel import mesh

import torch_spatial_ranks as sr
import torch_port_helpers  # noqa: F401  (one torch thread a process)

#: the level whose down step gathers (None: every level sliced), by (net,
#: S) at 16^3 (ACDC 32^2): slabs of 8, 4, 2, 1 (S = 2) or 4, 2, 1 (S = 4)
FIRST = {("la", 2): 3, ("pancreas", 2): 3, ("acdc", 2): None,
         ("la", 4): 2, ("pancreas", 4): 2, ("acdc", 4): 3}


def net_tasks(W, sp):
    """The forward and NMS tasks of a world of W ranks at S = sp."""
    rng = np.random.default_rng(W + sp)
    D = W // sp
    t = {}
    # four rows a data index: the 16^3 V-Net's bottom BatchNorm then
    # normalises four voxels a channel
    for kind, (c, S) in (("la", (2, sr.P3)), ("pancreas", (2, sr.P3)),
                         ("acdc", (4, sr.P2))):
        t[f"fwd_{kind}"] = ("forward", sp, (
            kind, sr.state_dict(kind), rng.normal(size=(4 * D, 1, *S)),
            rng.normal(size=(4 * D, c, *S))))
    t["nms_la"] = ("nms", sp, ((rng.random((2 * D, *sr.P3)) < 0.6).astype(
        np.int32), "la"))
    t["nms_pancreas"] = ("nms", sp, ((rng.random((2 * D, *sr.P3)) < 0.5)
                                     .astype(np.int32), "pancreas"))
    t["nms_acdc"] = ("nms", sp, (rng.integers(0, 4, (2 * D, *sr.P2))
                                 .astype(np.int32), "acdc"))
    return t


def check_forward(wr, one, W, sp, kind):
    want = one[f"fwd_{kind}"][0]
    # gradients to 1e-9, with a floor of 1e-13 of the net's largest
    # gradient: the 16^3 V-Net's bottom BatchNorm normalises four voxels a
    # channel, whose backward amplifies f64 reassociation noise, and a
    # parameter whose gradient is 0 in exact arithmetic (a conv bias in
    # front of a norm; pancreas' block_five_up, fed the instance norm of
    # one voxel) keeps the rounding of sums of terms as large as the net's
    # gradients
    floor = 1e-13 * max(np.abs(v).max() for v in want[2].values())
    for r, got in enumerate(wr[f"fwd_{kind}"]):
        sr.close(got[0], sr.part(want[0], r, W, sp, 2), "logits")
        assert got[1] == pytest.approx(want[1], rel=1e-10)
        for k, v in want[2].items():
            sr.close(got[2][k], v, k, rel=1e-9, floor=floor)
        sr.close(got[3], sr.part(want[3], r, W, sp, 2), "dx", rel=1e-9)
        for k, v in want[4].items():
            sr.close(got[4][k], v, k)
        assert got[5] == FIRST[(kind, sp)]


def check_nms(wr, one, W, sp, variant):
    want = one[f"nms_{variant}"][0]
    for r, got in enumerate(wr[f"nms_{variant}"]):
        np.testing.assert_array_equal(got, sr.part(want, r, W, sp, 1))


@pytest.fixture(scope="module")
def runs():
    """(the two ranks' results, the one process's)."""
    rng = np.random.default_rng(7)
    tasks = net_tasks(2, 2)
    world = mesh.launch(sr.run_tasks, 2, "cpu", dict(
        tasks, collectives=("collectives", 2,
                            (rng.normal(size=(1, 2, 6, 3, 2)),)),
        trainer=("trainer_checks", 2, ())))
    return world, sr.run_tasks(tasks)


def test_halo_gather_and_space_sum_with_gradcheck(runs):
    got = runs[0]["collectives"]
    x = np.random.default_rng(7).normal(size=(1, 2, 6, 3, 2))
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (0, 0), (0, 0)))
    for s, res in enumerate(got):
        np.testing.assert_array_equal(res["halo"], xp[:, :, 3 * s:3 * s + 5])
        np.testing.assert_array_equal(res["gather"], x)
        np.testing.assert_allclose(res["sum"], x.sum((2, 3, 4)),
                                   rtol=1e-14)
        for k in ("halo", "gather", "sum"):
            assert res[f"{k}_gradcheck"] is True, (s, k)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("route", ["unfused", "fused", "f_conv3d"])
def test_pad_and_crop_conv_of_slabs_is_the_whole_conv(S, route):
    """Slab by slab, the conv's output, dx and dW equal the whole-volume
    conv's (the plain versions of B, B-as-dx and C, or D, or the Ci = 1
    ``F.conv3d`` that is VALID in x)."""
    g = torch.Generator().manual_seed(S)
    ci = 1 if route == "f_conv3d" else 16
    x = torch.randn(2, ci, 8, 6, 5, generator=g, dtype=torch.float64)
    w = torch.randn(16, ci, 3, 3, 3, generator=g, dtype=torch.float64)
    dy = torch.randn(2, 16, 8, 6, 5, generator=g, dtype=torch.float64)

    def conv(t, halo):
        if route == "f_conv3d":
            return torch.nn.functional.conv3d(
                t, w, padding=(0, 1, 1) if halo else 1)
        return Conv3x3x3Function.apply(t, w, route == "fused", halo)

    xw = x.clone().requires_grad_()
    w.requires_grad_()
    conv(xw, False).backward(dy)
    want_dx, want_dw = xw.grad, w.grad.clone()
    w.grad = None
    pads = [p.requires_grad_() for p in mesh.halo_slabs(x, S)]
    ys = [conv(p, True) for p in pads]
    torch.testing.assert_close(torch.cat(ys, 2), conv(x, False),
                               rtol=1e-12, atol=1e-12)
    torch.autograd.backward(ys, list(dy.chunk(S, 2)))
    torch.testing.assert_close(mesh.fold_slabs([p.grad for p in pads]),
                               want_dx, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(w.grad, want_dw, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["la", "pancreas", "acdc"])
def test_train_forward_and_backward_equal_one_process(runs, kind):
    check_forward(*runs, 2, 2, kind)


@pytest.mark.parametrize("variant", ["la", "pancreas", "acdc"])
def test_nms_on_gathered_masks_equals_one_process(runs, variant):
    check_nms(*runs, 2, 2, variant)


# ---------------- the feed and the refusals ----------------
def _feed_data(variant):
    from bcp_tpu_torch.data.datasets import PancreasList, SliceList, VolumeList
    from bcp_tpu_torch.data.synthetic import (acdc_cases, la_cases,
                                              pancreas_cases)
    if variant == "la":
        return VolumeList(la_cases(16, (22, 20, 18), seed=11))
    if variant == "acdc":
        return SliceList(acdc_cases(20, ((40, 36),), seed=11)[0])
    lab, unlab, _ = pancreas_cases(6, 8, 0, ((20, 18, 22),), seed=5)
    return PancreasList(lab), PancreasList(unlab, "train_unlab")


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("variant", ["la", "acdc", "pancreas"])
def test_feed_keeps_each_ranks_rows_then_its_x_slab(monkeypatch, variant,
                                                     K):
    """At N = 4, S = 2 (``data_scale`` 2): rank (d, s)'s batch is data
    index d's rows of the global batch cut to x slab s, labels included,
    K-stacked too; the device store is refused under a split."""
    from bcp_tpu_torch.config import acdc_config, la_config, pancreas_config
    from bcp_tpu_torch.data import feed
    from bcp_tpu_torch.data.feed import BCPBatchFeeder
    monkeypatch.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    cfg = {"la": la_config(labelnum=8, patch_size=(16, 16, 12)),
           "acdc": acdc_config(labelnum=1, patch_size=(32, 32),
                               batch_size=8, labeled_bs=4),
           "pancreas": pancreas_config(20, patch_size=(16, 16, 16))}[
        variant].replace(compute_dtype="float32", device_data_cache=False)
    data = _feed_data(variant)
    whole = BCPBatchFeeder(cfg, "self", data, device="cpu", stack=K,
                           data_scale=2)
    parts = {(d, s): BCPBatchFeeder(cfg, "self", data, device="cpu",
                                    stack=K, data_scale=2, rank=d,
                                    space=(s, 2))
             for d in range(2) for s in range(2)}
    try:
        for _ in range(2):
            want = next(whole)
            got = {ds: next(f) for ds, f in parts.items()}
            for k, v in want.items():
                row = int(K > 1)
                x = (1 if k.startswith("lab") else 2) + row
                rows = v.shape[row] // 2
                for (d, s), b in got.items():
                    w = v.narrow(row, d * rows, rows)
                    w = w.narrow(x, s * w.shape[x] // 2, w.shape[x] // 2)
                    assert torch.equal(b[k], w), (k, d, s)
    finally:
        whole.close()
        for f in parts.values():
            f.close()
    with pytest.raises(ValueError, match="single-device"):
        BCPBatchFeeder(cfg.replace(device_data_cache=True), "pre", data,
                       device="cpu", rank=0, space=(0, 2))


def test_trainer_in_a_world_of_two_at_sp_2(runs):
    """One data index (the global batch is one reference batch), and a
    patch whose x extent the split cannot divide refused, as the JAX
    trainer does."""
    for scale, refusal in runs[0]["trainer"]:
        assert scale == 1
        assert refusal == ("sp_devices=2 must divide the patch's leading "
                           "spatial extent 15")


def test_trainer_refuses_a_split_without_its_ranks():
    """``sp_devices`` 2 outside a world: the JAX trainer's refusal."""
    from bcp_tpu_torch.config import la_config
    from bcp_tpu_torch.train.trainer import BCPTrainer
    cfg = la_config(labelnum=4, patch_size=(16, 16, 16), n_filters=4,
                    sp_devices=2)
    with pytest.raises(ValueError, match="sp_devices=2 needs a mesh with a "
                                         "matching 'space' axis"):
        BCPTrainer(cfg, device="cpu", val_cases=[])
