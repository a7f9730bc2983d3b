"""The trainer's image snapshots (``train/snapshots.py``, ``log_images``)
against the JAX package: the LA grid bit for bit, the LA and ACDC panels
against ``make_la_snapshot_fn`` / ``make_acdc_snapshot_fn`` on the same
state, batch and mask (float64 on both sides, dropout off: images and
labels bit for bit, probabilities to 1e-9), the reference's cadences, and
the trainer handing the writer the same panels at K = 2 as at K = 1."""

import copy

import jax
import numpy as np
import pytest
import torch

from bcp_tpu.config import acdc_config as jax_acdc_config
from bcp_tpu.config import la_config as jax_la_config
from bcp_tpu.models import UNet2D as FlaxUNet2D
from bcp_tpu.models import VNet3D as FlaxVNet3D
from bcp_tpu.train import snapshots as jax_snapshots
from bcp_tpu.train.state import build_optimizer as jax_build_optimizer
from bcp_tpu.train.state import init_state as jax_init_state
from bcp_tpu_torch import convert
from bcp_tpu_torch.config import acdc_config, la_config
from bcp_tpu_torch.data import feed
from bcp_tpu_torch.data.datasets import SliceList, VolumeList
from bcp_tpu_torch.data.synthetic import acdc_cases, la_cases
from bcp_tpu_torch.models import UNet2D, VNet3D
from bcp_tpu_torch.ops.masks import cuboid_mask
from bcp_tpu_torch.train import snapshots
from bcp_tpu_torch.train.state import TrainState, build_optimizer
from bcp_tpu_torch.train.steps import pseudo_labels
from bcp_tpu_torch.train.trainer import BCPTrainer
from bcp_tpu_torch.utils.logging import MetricWriter
from test_torch_steps import _f64, _np
from test_torch_train_ops import jax_cuboid_starts
from torch_port_helpers import unet_chns


@pytest.mark.parametrize("flat", [False, True])
def test_la_snapshot_grid_matches_jax(flat):
    """(D, 3, 3H + 6, W + 2) with the white separators, bit for bit; a
    constant image (no range to normalise by) included."""
    rng = np.random.default_rng(0)
    H, W, D = 9, 7, 5
    img = (np.full((H, W, D), 0.3) if flat else rng.normal(size=(H, W, D))
           ).astype(np.float32)
    lab = (rng.random((H, W, D)) > 0.5).astype(np.float32)
    prob = rng.random((H, W, D)).astype(np.float32)
    got = snapshots.la_snapshot_grid(img, lab, prob)
    assert got.shape == (D, 3, 3 * H + 6, W + 2)
    np.testing.assert_array_equal(
        got, jax_snapshots.la_snapshot_grid(img, lab, prob))


def _blobs(rng, n, shape, classes):
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"))
    lab = np.zeros((n, *shape), np.uint8)
    for c in range(1, classes):
        ctr = rng.uniform(3, min(shape) - 3,
                          size=(n, len(shape)) + (1,) * len(shape))
        lab[((g[None] - ctr) ** 2).sum(1) <= rng.uniform(8, 20)] = c
    img = rng.normal(0, 0.3, lab.shape) + 0.5 * lab
    return img[..., None].astype(np.float64), lab


def _batch(shape, classes, seed=4):
    rng = np.random.default_rng(seed)
    out = {}
    for k in ("a", "b"):
        out[f"img_{k}"], out[f"lab_{k}"] = _blobs(rng, 2, shape, classes)
        out[f"uimg_{k}"], out[f"ulab_{k}"] = _blobs(rng, 2, shape, classes)
    return out


def _to_port(batch):
    return {k: (torch.from_numpy(np.moveaxis(v, -1, 1)) if v.ndim ==
                len(batch["lab_a"].shape) + 1 else torch.from_numpy(v))
            for k, v in batch.items()}


def _states(fmodel, jcfg, cfg, port_net, kind):
    """(JAX state in f64, port TrainState) from the same random weights."""
    tx = jax_build_optimizer(jcfg, "self")
    st = jax_init_state(fmodel, jcfg, jax.random.PRNGKey(3), tx)
    params, stats = _f64(st.params), _f64(st.batch_stats)
    st = st.replace(params=params, batch_stats=stats,
                    teacher_params=_f64(params),
                    teacher_batch_stats=_f64(stats))
    sd = convert.state_dict_from_flax(
        _np({"params": params, "batch_stats": stats}), kind,
        dtype=np.float64)
    port_net.load_state_dict(sd, strict=True)
    port_net.train()
    return st, TrainState(port_net, copy.deepcopy(port_net),
                          build_optimizer(cfg, port_net.parameters()))


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_la_panels_match_jax(x64):
    """The mixed images and targets bit for bit (the mask from the JAX
    step's key, the pseudo-labels from the port's teacher and NMS), the
    pre-update student's class-1 probability to 1e-9."""
    patch = (16, 16, 16)
    kw = dict(n_filters=4, patch_size=patch, labelnum=4,
              compute_dtype="float32")
    jcfg, cfg = jax_la_config(**kw), la_config(**kw)
    fmodel = FlaxVNet3D(n_classes=2, n_filters=4, normalization="batchnorm",
                        has_dropout=False)
    jstate, state = _states(fmodel, jcfg, cfg,
                            VNet3D(n_classes=2, n_filters=4).double(),
                            "VNet")
    batch = {k: v for k, v in _batch(patch, 2).items()
             if not k.startswith("ulab")}
    key = jax.random.PRNGKey(7)
    fn = jax_snapshots.make_la_snapshot_fn(fmodel, fmodel, jcfg)
    want = {k: np.asarray(v) for k, v in fn(jstate, batch, key).items()}
    pbatch = _to_port(batch)
    mask = cuboid_mask(patch, jax_cuboid_starts(
        jax.random.split(key, 3)[0], patch))
    plab = pseudo_labels(state, pbatch, cfg)
    got = snapshots.make_la_snapshot(state, pbatch, mask, plab)
    assert sorted(got) == sorted(want)
    assert state.model.training
    for k, v in got.items():
        assert v.shape == patch
        if k.endswith("prob"):
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0,
                                       atol=1e-9, err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert 0 < got["mixl_lab"].sum() < got["mixl_lab"].numel()


@pytest.mark.parametrize("stage", ["pre", "self"])
def test_acdc_panels_match_jax(x64, stage):
    """Sample 1's mixed image bit for bit, its argmax x 50 and mixed
    (true) label x 50 equal, under the reference's tags."""
    patch = (32, 32)
    kw = dict(labelnum=1, n_filters=4, patch_size=patch, batch_size=8,
              labeled_bs=4, compute_dtype="float32")
    jcfg, cfg = jax_acdc_config(**kw), acdc_config(**kw)
    fmodel = FlaxUNet2D(n_classes=4, feature_chns=unet_chns(4),
                        dropout=(0.0,) * 5)
    jstate, state = _states(
        fmodel, jcfg, cfg, UNet2D(feature_chns=unet_chns(4),
                                  dropout=(0.0,) * 5).double(), "unet")
    batch = _batch(patch, 4)
    ulab = {k: batch.pop(k) for k in ("ulab_a", "ulab_b")}
    key = jax.random.PRNGKey(8)
    fn = jax_snapshots.make_acdc_snapshot_fn(fmodel, fmodel, jcfg, stage)
    if stage == "pre":
        jbatch = {k: v for k, v in batch.items() if not k.startswith("u")}
        want = fn(jstate, jbatch, key)
        mask_key = jax.random.split(key)[0]
    else:
        want = fn(jstate, batch, key, ulab["ulab_a"], ulab["ulab_b"])
        mask_key = jax.random.split(key, 3)[0]
    mask = cuboid_mask(patch, jax_cuboid_starts(mask_key, patch))
    got = snapshots.make_acdc_snapshot(
        state, _to_port(batch), mask, cfg, stage,
        *(torch.from_numpy(ulab[k]) for k in ("ulab_a", "ulab_b")))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got[next(k for k in got if k.endswith("GroundTruth"))].max() > 0


@pytest.mark.parametrize("variant,stage,want", [
    ("la", "pre", []), ("la", "self", [1, 201]),
    ("acdc", "pre", list(range(20, 401, 20))),
    ("acdc", "self", list(range(20, 401, 20))),
    ("pancreas", "pre", []), ("pancreas", "self", [])])
def test_cadences_are_the_references(variant, stage, want):
    """LA self-train at ``it % eval_every == 1``, ACDC every 20, none for
    LA pre-train or pancreas (`trainer.py:633-643`)."""
    trainer = BCPTrainer.__new__(BCPTrainer)
    trainer.cfg = la_config(eval_every=200).replace(variant=variant)
    assert [it for it in range(1, 401)
            if trainer._snapshot_due(it, stage)] == want


def _record(monkeypatch):
    """The writer's image calls: (kind, tag, array, step)."""
    calls = []
    monkeypatch.setattr(MetricWriter, "image", lambda self, tag, img, it:
                        calls.append(("image", tag, img, it)))
    monkeypatch.setattr(MetricWriter, "images", lambda self, tag, imgs,
                        it=None: calls.append(("images", tag, imgs, it)))
    return calls


def _trainer(tmp, variant, K):
    if variant == "la":
        cfg = la_config(labelnum=4, n_filters=4, patch_size=(16,) * 3,
                        batch_size=4, labeled_bs=2, eval_every=2)
        data = VolumeList(la_cases(8, (20, 20, 18), seed=11))
        val = la_cases(1, (24, 22, 20), seed=12)
    else:
        cfg = acdc_config(labelnum=1, n_filters=4, patch_size=(32, 32),
                          batch_size=8, labeled_bs=4, eval_every=4)
        slices, val = acdc_cases(16, ((40, 36), (36, 44)), 1, (3, 40, 36),
                                 seed=1)
        data = SliceList(slices)
    cfg = cfg.replace(snapshot_root=str(tmp), pre_iterations=2,
                      self_iterations=4, steps_per_dispatch=K,
                      compute_dtype="float32")
    return BCPTrainer(cfg, device="cpu", train_dataset=data, val_cases=val,
                      log_images=True)


@pytest.mark.parametrize("variant", ["la", "acdc"])
def test_trainer_hands_the_same_panels_at_k2(tmp_path, monkeypatch,
                                            variant):
    """Both stages (2 + 4 iterations) with ``log_images``: LA's two grids
    at self-train iterations 1 and 3 (eval_every 2), ACDC's panels at
    every second iteration (the cadence shortened from 20 for the test),
    at K = 2 the same arrays, tags and steps as at K = 1, each sub-step's
    taken before its update."""
    monkeypatch.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    if variant == "acdc":
        monkeypatch.setattr(BCPTrainer, "_snapshot_due",
                            lambda self, it, stage: it % 2 == 0)
    runs = []
    for K in (1, 2):
        calls = _record(monkeypatch)
        trainer = _trainer(tmp_path / f"k{K}", variant, K)
        trainer.pretrain()
        trainer.selftrain()
        runs.append(calls)
    want, got = runs
    assert [c[:2] + c[3:] for c in got] == [c[:2] + c[3:] for c in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[2], b[2], err_msg=a[1])
    if variant == "la":
        assert [c[1] for c in want] == [
            "Epoch_0_Iter_1_labeled", "Epoch_0_Iter_1_unlabel",
            "Epoch_1_Iter_3_labeled", "Epoch_1_Iter_3_unlabel"]
        assert want[0][2].shape == (16, 3, 3 * 16 + 6, 16 + 2)
        assert want[0][2].dtype == np.float32
    else:
        tags = [c[1] for c in want]
        assert tags[:3] == ["pre_train/Mixed_Image",
                            "pre_train/Mixed_Prediction",
                            "pre_train/Mixed_GroundTruth"]
        assert len(tags) == 3 + 2 * 6
        assert [c[3] for c in want] == [2] * 3 + [2] * 6 + [4] * 6
        assert want[0][2].shape == (1, 32, 32)
