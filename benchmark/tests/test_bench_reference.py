"""The plain reference against the port's CPU path at a tiny size in
float64: the feed's batches and the iteration's draws, one self-train
update (losses, the student's and the teacher's parameters) and one
volume's score map. The test imports both; the reference never imports
the port."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from bench_helpers import ROOT  # noqa: F401  (puts the checkout on the path)
from benchmark import data
from benchmark.reference import bcp, nets, sliding

from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.data.datasets import VolumeList
from bcp_tpu_torch.data.feed import BCPBatchFeeder
from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator
from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.train.state import init_state, load_weights_only
from bcp_tpu_torch.train.steps import selftrain_step
from bcp_tpu_torch.train.trainer import copy_paste_mask, iteration_draws

SEED = 2**31 + 3
PATCH = (32, 32, 32)
VNET = {"n_filters": 4, "n_classes": 2}


def _cfg():
    return {"reference_net": "vnet", "widths": VNET, "patch_size": PATCH,
            "train": {"base_lr": 0.01, "momentum": 0.9,
                      "weight_decay": 1e-4, "ema_alpha": 0.99,
                      "mask_ratio": 2 / 3, "u_weight": 0.5, "nms": True,
                      "stage_seed_offset": 1}}


def _volumes():
    return data.blob_volumes(SEED, 0, 10, (40, 36, 34), "cpu")


def _port_cfg():
    return la_config(labelnum=4).replace(
        patch_size=PATCH, n_filters=4, compute_dtype="float32",
        max_samples=10, seed=SEED, device_data_cache=True)


def test_feed_and_draws_match_the_trainers():
    vols = _volumes()
    cfg = _port_cfg()
    feeder = BCPBatchFeeder(cfg, "self", VolumeList(vols), "cpu")
    feed = bcp.Feed(vols, 4, 8, 4, PATCH, SEED)
    for _ in range(3):
        got, want = next(feeder), feed.next()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v.astype(
                got[k].numpy().dtype))
    gen = torch.Generator()
    for it in (1, 2, 7):
        mask = copy_paste_mask(cfg, iteration_draws(SEED + 1, it, gen))
        starts, sizes = bcp.mask_box(SEED + 1, it, PATCH, 2 / 3)
        want = torch.ones(PATCH, dtype=mask.dtype)
        want[tuple(slice(s, s + n) for s, n in zip(starts, sizes))] = 0
        assert torch.equal(mask, want)
        ref_gen = torch.Generator()
        ref_gen.manual_seed(bcp.dropout_seed(SEED + 1, it))
        assert torch.equal(torch.rand(5, generator=gen),
                           torch.rand(5, generator=ref_gen))


def test_one_selftrain_update_in_f64():
    vols = _volumes()
    weights = data.seeded_weights("vnet", VNET, SEED, "cpu")
    batch = bcp.Feed(vols, 4, 8, 4, PATCH, SEED).next()
    # the port's state and step
    cfg = _port_cfg()
    state = init_state(cfg, "cpu")
    load_weights_only(state, weights)
    state.model.double()
    state.teacher.double()
    port_batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in batch.items()}
    port_batch = {k: v.double() if v.is_floating_point() else v
                  for k, v in port_batch.items()}
    gen = torch.Generator()
    mask = copy_paste_mask(cfg, iteration_draws(SEED + 1, 1, gen))
    losses = selftrain_step(state, port_batch, mask, cfg, gen, gen)
    # the reference's
    ref = bcp.SelfTrain(_cfg(), weights, "cpu")
    ref.model.double()
    ref.ema.double()
    ref.seed = SEED
    loss = ref.step(copy.deepcopy(batch), 1)
    assert float(losses["loss"]) == pytest.approx(loss, rel=1e-9)
    for (n, p), (_, q) in zip(state.model.named_parameters(),
                              ref.model.named_parameters()):
        torch.testing.assert_close(p, q, rtol=1e-7, atol=1e-9, msg=n)
    for (n, p), (_, q) in zip(state.teacher.named_parameters(),
                              ref.ema.named_parameters()):
        torch.testing.assert_close(p, q, rtol=1e-7, atol=1e-9, msg=n)


def test_one_volume_score_map_in_f64():
    vol = data.blob_volumes(SEED, 4, 1, (40, 36, 34), "cpu")[0][0]
    calib = torch.from_numpy(np.ascontiguousarray(
        vol[:32, :32, :32]))[None, None]
    weights = data.seeded_weights("vnet", VNET, SEED, "cpu",
                                  calibrate=calib)
    model = create_model("VNet", 2, mode="test", device="cpu",
                         n_filters=4).double()
    model.load_state_dict(weights)
    ev = SlidingWindowEvaluator(model, PATCH, 2, 18, 4, batch=4,
                                device="cpu")
    label, score = ev.infer(vol, return_score=True)
    ref = nets.RefVNet(4, 2).double().eval()
    ref.load_state_dict(weights)
    want = sliding.scores(ref, vol.astype(np.float64), PATCH, 18, 4, 2,
                          "cpu", 4)
    # the port's score map is f32
    np.testing.assert_allclose(score, want.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(label, (want[1] > 0.5).numpy())
