"""The model zoo through the port's evaluators and ``test_la``: the
dual-task UNet3D and a model that returns a bare tensor through
``SlidingWindowEvaluator`` against the JAX evaluator, the bare-tensor
``UNet_2dBCP`` through ``Slice2DEvaluator`` against the JAX one (both
evaluators take the first element of a tuple and a bare tensor as it is),
and ``test_la --model unet_3D`` on the port's own checkpoint against the JAX
evaluator and metrics."""

import os
import re

import numpy as np
import pytest
import torch

from flax import linen as nn

from bcp_tpu.eval import metrics as jax_metrics
from bcp_tpu.eval.slice2d import Slice2DEvaluator as JaxSlice2D
from bcp_tpu.eval.sliding_window import SlidingWindowEvaluator as JaxEvaluator
from bcp_tpu.models import create_model as flax_create
from bcp_tpu_torch.cli import test_la
from bcp_tpu_torch.convert import state_dict_from_flax
from bcp_tpu_torch.data.datasets import VolumeList
from bcp_tpu_torch.eval.slice2d import Slice2DEvaluator
from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator
from bcp_tpu_torch.models import factory
from bcp_tpu_torch.train.checkpoints import best_model_path, snapshot_dir
from torch_port_helpers import flax_zoo, port_zoo

NARROW = dict(feat_channels=(2, 4, 4, 8, 8))


def _image(seed, shape=(20, 18, 17)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_dual_task_unet3d_matches_jax_evaluator():
    """`test_DTC_single_case`'s rule: the tanh head is softmaxed."""
    model, variables, _ = flax_zoo("unet_3D_dtc", seed=3)
    image = _image(3)
    want_label, want_score = JaxEvaluator(
        model, (16, 16, 16), 2, 4, 4, batch=4).infer(variables, image,
                                                     rule="argmax")
    ev = SlidingWindowEvaluator(port_zoo("unet_3D_dtc", variables),
                                (16, 16, 16), 2, 4, 4, batch=4,
                                device="cpu")
    label, score = ev.infer(image, rule="argmax")
    np.testing.assert_allclose(score, want_score, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(label, want_label)


class _FlaxBare(nn.Module):
    """A 3-D net whose output is a bare tensor (the logits alone)."""

    @nn.compact
    def __call__(self, x, train=False):
        return flax_create("unet_3D", 2, **NARROW, name="net")(x, train)[0]


class _Bare(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return self.net(x)[0]


def test_bare_tensor_model_through_sliding_window():
    _, variables, _ = flax_zoo("unet_3D_narrow", seed=5)
    image = _image(5, (21, 16, 18))
    want_label, want_score = JaxEvaluator(
        _FlaxBare(), (16, 16, 16), 2, 5, 5, batch=2).infer(
        {k: {"net": v} for k, v in variables.items()}, image)
    ev = SlidingWindowEvaluator(_Bare(port_zoo("unet_3D_narrow", variables)),
                                (16, 16, 16), 2, 5, 5, batch=2, device="cpu")
    label, score = ev.infer(image)
    np.testing.assert_allclose(score, want_score, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(label, want_label)


def test_bare_tensor_unet_2d_bcp_through_slice2d():
    model, variables, _ = flax_zoo("unet_2d_bcp", seed=6)
    net = port_zoo("unet_2d_bcp", variables)
    volume = _image(6, (3, 40, 26))
    want = np.asarray(JaxSlice2D(model, (32, 32), 4).predict_volume(
        variables, volume))
    got = Slice2DEvaluator(net, (32, 32), 4, device="cpu").predict_volume(
        volume)
    assert got.shape == volume.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def narrow_unet3d(monkeypatch):
    """The registry's unet_3D at NARROW widths, so the CLI builds it."""
    full = factory.MODEL_REGISTRY["unet_3D"]
    monkeypatch.setitem(factory.MODEL_REGISTRY, "unet_3D",
                        lambda c, m, **kw: full(c, m, **NARROW, **kw))


def _flags(root):
    return ["--root_path", str(root), "--snapshot_root", str(root),
            "--model", "unet_3D", "--patch_size", "16", "16", "16",
            "--stride_xy", "6", "--stride_z", "6", "--eval_batch", "4",
            "--device", "cpu"]


def test_test_la_evaluates_unet3d_from_its_own_checkpoint(
        narrow_unet3d, tmp_path, monkeypatch, capsys):
    model, variables, _ = flax_zoo("unet_3D_narrow", seed=7)
    la = test_la.la_config
    monkeypatch.setattr(test_la, "la_config", lambda *a, **k: la(
        *a, **k).replace(compute_dtype="float32"))
    args = test_la.build_parser().parse_args(_flags(tmp_path))
    cfg = la(labelnum=4).replace(snapshot_root=str(tmp_path))
    path = best_model_path(snapshot_dir(cfg, "self_train"), "unet_3D")
    os.makedirs(os.path.dirname(path))
    torch.save(state_dict_from_flax(variables, "unet_3D"), path)
    rng = np.random.default_rng(8)
    cases = [(_image(9 + i), (rng.random((20, 18, 17)) > 0.7).astype(
        np.uint8)) for i in range(2)]
    avg = test_la.test_calculate_metric(args, dataset=VolumeList(cases))
    out = capsys.readouterr().out
    assert len(re.findall(r"^\d\d,\t", out, re.M)) == 2
    ev = JaxEvaluator(model, (16, 16, 16), 2, 6, 6, batch=4)
    want = []
    for image, label in cases:
        pred, _ = ev.infer(variables, image, rule="threshold")
        pred = jax_metrics.host_largest_cc(pred)
        want.append((0.0,) * 4 if pred.sum() == 0 else
                    jax_metrics.calculate_metric_percase(pred, label))
    np.testing.assert_allclose(avg, np.mean(want, axis=0), rtol=1e-6)
    # a reference .pth of a zoo net has no known layout: the JAX
    # converter's KeyError
    with pytest.raises(KeyError, match="no torch mapping"):
        test_la.main(_flags(tmp_path) + ["--torch_ckpt", path])


def test_test_la_refuses_unetr_at_another_window(tmp_path):
    args = test_la.build_parser().parse_args(
        ["--snapshot_root", str(tmp_path), "--model", "unetr",
         "--device", "cpu"])
    ev = SlidingWindowEvaluator(
        factory.create_model("unetr", 2, device="cpu", img_shape=(32,) * 3,
                             embed_dim=32, num_heads=2, num_layers=4,
                             d_ff=64, width_scale=0.125),
        tuple(args.patch_size), 2, 18, 4, batch=1, device="cpu")
    with pytest.raises(ValueError, match="img_shape"):
        ev.infer(_image(1, (112, 112, 80)))
