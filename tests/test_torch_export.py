"""The port's ``export_torch`` and ``kde_demo`` CLIs against the JAX
package's: the export equals ``bcp_tpu.convert.export_state_dict`` bit for
bit from the same weights and template and loads with ``strict=True`` into
a module with the reference's dead heads; pancreas needs its template and
takes its head index from it; the KDE demo draws the JAX package's batches,
computes its rows and writes its plot."""

import os
import re
import struct
import zlib

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from bcp_tpu.cli import kde_demo as jax_kde
from bcp_tpu.convert.torch_ckpt import export_state_dict as jax_export
from bcp_tpu.data import transforms as jax_transforms
from bcp_tpu.data.sampler import TwoStreamBatchSampler as JaxTwoStream
from bcp_tpu.models import UNet2D as FlaxUNet2D
from bcp_tpu.models import create_model as flax_create
from bcp_tpu_torch.cli import export_torch, kde_demo
from bcp_tpu_torch.config import acdc_config, la_config, pancreas_config
from bcp_tpu_torch.convert import state_dict_from_flax
from bcp_tpu_torch.data import feed
from bcp_tpu_torch.data.datasets import SliceList
from bcp_tpu_torch.data.synthetic import acdc_cases
from bcp_tpu_torch.models import VNet3D, VNetPancreas
from bcp_tpu_torch.train.checkpoints import best_model_path, snapshot_dir
from torch_port_helpers import _randomised_tree, flax_vnet_variables


class _WithHeads(VNet3D):
    """The reference LA V-Net's state_dict layout: the port's plus the
    dead contrastive heads."""

    def __init__(self):
        super().__init__(n_classes=2, n_filters=4)
        self.projection_head = nn.Sequential(nn.Linear(16, 8),
                                             nn.BatchNorm1d(8))
        self.prediction_head = nn.Sequential(nn.Linear(8, 8))


class _PancreasWithDropout(VNetPancreas):
    """The reference pancreas V-Net built with dropout: its head at
    ``branchs.0.2``."""

    def __init__(self):
        super().__init__(n_classes=2, n_filters=4)
        head = self.branchs[0][1]
        self.branchs[0] = nn.Sequential(self.branchs[0][0], nn.Dropout3d(),
                                        head)


def _save_ckpt(root, cfg, name, sd):
    path = best_model_path(snapshot_dir(cfg, "self_train"), name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)
    return path


def _hold_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


def test_la_export_equals_jax_and_loads_strict(tmp_path):
    _, variables = flax_vnet_variables(seed=3)
    cfg = la_config(labelnum=4).replace(snapshot_root=str(tmp_path))
    _save_ckpt(tmp_path, cfg, "VNet", state_dict_from_flax(variables))
    template = _WithHeads().state_dict()
    tpl = tmp_path / "fresh.pth"
    torch.save(template, tpl)
    out = tmp_path / "ref.pth"
    got = export_torch.main(["--variant", "la", "--labelnum", "4",
                             "--snapshot_root", str(tmp_path), "--template",
                             str(tpl), "--out", str(out)])
    _hold_equal(got, jax_export(variables, "VNet", template=template))
    ref = _WithHeads()
    ref.load_state_dict(torch.load(out, weights_only=True), strict=True)
    # without a template: only the port's weights, loadable non-strictly
    bare = export_torch.main(["--variant", "la", "--labelnum", "4",
                              "--snapshot_root", str(tmp_path), "--out",
                              str(out)])
    assert not any(k.startswith("projection_head") for k in bare)
    res = _WithHeads().load_state_dict(bare, strict=False)
    assert res.missing_keys and not res.unexpected_keys


@pytest.mark.parametrize("dropout", [False, True])
def test_pancreas_export_takes_the_templates_head(tmp_path, dropout):
    model = flax_create("VNet_pancreas", 2, n_filters=4)
    variables = jax.tree_util.tree_map(np.asarray, dict(model.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 16, 16, 16, 1)), train=False)))
    cfg = pancreas_config().replace(snapshot_root=str(tmp_path))
    _save_ckpt(tmp_path, cfg, "VNet_pancreas",
               state_dict_from_flax(variables, "VNet_pancreas"))
    flags = ["--variant", "pancreas", "--snapshot_root", str(tmp_path),
             "--out", str(tmp_path / "p.pth")]
    with pytest.raises(ValueError, match="requires a template"):
        export_torch.main(flags)
    ref = (_PancreasWithDropout if dropout else VNetPancreas)
    template = (ref() if dropout else ref(n_classes=2, n_filters=4)
                ).state_dict()
    torch.save(template, tmp_path / "fresh.pth")
    got = export_torch.main(flags + ["--template",
                                     str(tmp_path / "fresh.pth")])
    want = jax_export(variables, "VNet_pancreas", template=template)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    head = "branchs.0.2.weight" if dropout else "branchs.0.1.weight"
    assert head in got


def test_acdc_export_equals_jax(tmp_path):
    fm = FlaxUNet2D(n_classes=4, dropout=(0.0,) * 5)
    variables = _randomised_tree(jax.tree_util.tree_map(np.asarray, dict(
        fm.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 1))))), 2)
    cfg = acdc_config(labelnum=3).replace(snapshot_root=str(tmp_path))
    sd = state_dict_from_flax(variables, "unet")
    # the reference's save_net_opt layout of an ACDC best file
    _save_ckpt(tmp_path, cfg, "unet", {"net": sd, "opt": {}})
    template = dict(sd)
    template["projection_head.0.weight"] = torch.zeros(3, 16)
    torch.save(template, tmp_path / "fresh.pth")
    got = export_torch.main(["--variant", "acdc", "--labelnum", "3",
                             "--snapshot_root", str(tmp_path), "--template",
                             str(tmp_path / "fresh.pth"), "--out",
                             str(tmp_path / "a.pth")])
    _hold_equal(got, jax_export(variables, "unet", template=template))


def _png_size(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    raw = zlib.decompress(idat)
    assert len(raw) == h * (1 + 3 * w)
    return w, h


def test_select_and_plot_equal_jax(tmp_path, capsys):
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(401, 6)).astype(np.float32)
    pred = rng.integers(0, 3, 401)
    label = np.where(rng.random(401) < 0.6, pred, rng.integers(0, 3, 401))
    for cls in (0, 2):
        got = kde_demo.select_correct_pixels(pred, label, cls, 201)
        want = jax_kde.select_correct_pixels(pred, label, cls, 201)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    want_path = jax_kde.plot_kde(feats, pred, label, 2, 6, 0, 3,
                                 str(tmp_path / "jax"))
    want_out = capsys.readouterr().out
    got_path = kde_demo.plot_kde(feats, pred, label, 2, 6, 0, 3,
                                 str(tmp_path / "port"))
    got_out = capsys.readouterr().out
    assert os.path.relpath(got_path, tmp_path / "port") == \
        os.path.relpath(want_path, tmp_path / "jax")
    assert got_out.splitlines()[0] == want_out.splitlines()[0]
    assert _png_size(got_path) == kde_demo.FIGURE[::-1]
    assert kde_demo.plot_kde(feats, pred, np.full(401, 9), 2, 6, 0, 3,
                             str(tmp_path)) is None


def test_kde_run_draws_the_jax_batches_and_rows(tmp_path, monkeypatch):
    """``run`` on slices in memory: the two-stream batches and crops of
    the JAX package's sampler and transform from one seed, the batched
    forward's rows equal to the JAX ``batch_rows`` from the same weights
    (f32, 32x32 crops), and a PNG per batch."""
    monkeypatch.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    monkeypatch.setattr(kde_demo, "acdc_config", lambda *a, **k: acdc_config(
        *a, **k).replace(patch_size=(32, 32), compute_dtype="float32"))
    fm = FlaxUNet2D(n_classes=4, dropout=(0.0,) * 5)
    variables = _randomised_tree(jax.tree_util.tree_map(np.asarray, dict(
        fm.init(jax.random.PRNGKey(6), jnp.zeros((1, 32, 32, 1))))), 6)
    cfg = acdc_config(labelnum=1).replace(snapshot_root=str(tmp_path))
    _save_ckpt(tmp_path, cfg, "unet", state_dict_from_flax(variables,
                                                           "unet"))
    slices, _ = acdc_cases(20, ((40, 36), (28, 44)), seed=7)
    seen = []
    real = kde_demo.plot_kde

    def capture(*a, **k):
        seen.append(a[:3])
        return real(*a, **k)

    monkeypatch.setattr(kde_demo, "plot_kde", capture)
    args = kde_demo.build_parser().parse_args(
        ["--labelnum", "1", "--snapshot_root", str(tmp_path), "--max_pics",
         "2", "--specific_class", "0", "--out_dir", str(tmp_path),
         "--device", "cpu"])
    paths = kde_demo.run(args, dataset=SliceList(slices))
    assert len(paths) == len(seen) == 2
    sampler = JaxTwoStream(range(8), range(8, 20), 4, 2, seed=1337)
    rng = np.random.default_rng(1337)
    batches = sampler.epoch()
    for (feats, pred, label), path in zip(seen, paths):
        lab_ids, unlab_ids = next(batches)
        imgs, labs = zip(*(jax_transforms.acdc_random_generator(
            *slices[i], (32, 32), rng) for i in lab_ids + unlab_ids))
        w_feats, w_pred, w_label, f_dim = jax_kde.batch_rows(
            fm, variables, np.stack(imgs), np.stack(labs))
        assert f_dim == 16
        np.testing.assert_array_equal(label, w_label)
        np.testing.assert_allclose(feats, w_feats, rtol=1e-4, atol=1e-4)
        assert (pred == w_pred).mean() > 0.999
        if path is not None:
            assert re.search(r"KDE/ACDC/16/labeled_1/class_0/"
                             r"kde_test_mean\d_1_0\.png$", path)
            assert _png_size(path) == kde_demo.FIGURE[::-1]
