"""The port's test_la CLI against bcp_tpu.cli.test_la on one .pth and one
tiny synthetic LA set; the port's synthetic data and dataset reader."""

import gzip
import os
import re
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from bcp_tpu.cli import test_la as jax_test_la
from bcp_tpu.data import synthetic as jax_synthetic
from bcp_tpu_torch.cli import test_la
from bcp_tpu_torch.convert import state_dict_from_flax
from bcp_tpu_torch.data import synthetic
from bcp_tpu_torch.data.datasets import LAHeartDataset, VolumeList
from torch_port_helpers import flax_vnet_variables

CASE_LINE = re.compile(r"^\d\d,\t\S+, \S+, \S+, \S+$", re.M)


def _flags(root, pth, snap):
    return ["--root_path", str(root), "--torch_ckpt", str(pth),
            "--snapshot_root", str(snap), "--patch_size", "16", "16", "16",
            "--n_filters", "4", "--stride_xy", "6", "--stride_z", "6",
            "--eval_batch", "4"]


@pytest.fixture(scope="module")
def la_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("la")
    jax_synthetic.make_la_dataset(str(root), n_train=1, n_test=2,
                                  shape=(20, 18, 17), seed=3)
    _, variables = flax_vnet_variables(seed=4)
    pth = root / "VNet_best_model.pth"
    torch.save(state_dict_from_flax(variables), pth)
    return root, pth


def test_cli_matches_jax_cli(la_set, tmp_path, capsys):
    root, pth = la_set
    jax_test_la.main(_flags(root, pth, tmp_path / "jax"))
    want_out = capsys.readouterr().out
    test_la.main(_flags(root, pth, tmp_path / "port") + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert len(CASE_LINE.findall(got_out)) == \
        len(CASE_LINE.findall(want_out)) == 2
    perf = tmp_path / "port" / "LA_BCP_4_labeled" / "performance.txt"
    assert perf.read_text().startswith("average metric is")

    def avg(out):
        rows = [list(map(float, line.split("\t")[1].split(", ")))
                for line in CASE_LINE.findall(out)]
        return np.mean(rows, axis=0)

    np.testing.assert_allclose(avg(got_out), avg(want_out), rtol=2e-2,
                               atol=2e-2)


def test_cli_takes_a_dataset_object(la_set, tmp_path, capsys):
    root, pth = la_set
    cases = [LAHeartDataset(str(root), "test").load(i) for i in range(2)]
    args = test_la.build_parser().parse_args(
        _flags(root, pth, tmp_path) + ["--device", "cpu", "--nms", "0"])
    avg = test_la.test_calculate_metric(args, dataset=VolumeList(cases))
    assert avg.shape == (4,) and np.isfinite(avg).all()
    assert len(CASE_LINE.findall(capsys.readouterr().out)) == 2


@pytest.mark.parametrize("flag", [
    ["--save_result", "1"],
    ["--num_devices", str(torch.cuda.device_count() + 2), "--device",
     "cuda"]])
def test_cli_refuses_what_the_port_lacks(la_set, tmp_path, monkeypatch,
                                         flag):
    """``--num_devices`` evaluates on that many cards
    (``tests/test_torch_parallel_cli.py``) and is refused when fewer are
    visible, never run on fewer (ROADMAP A4);
    ``--save_result 1`` writes the JAX CLI's files
    (``%02d_{pred,img,gt}.nii.gz``) with the same decompressed contents,
    both CLIs computing in f32 (in bf16 a few voxels near the threshold
    differ between the two)."""
    root, pth = la_set
    if flag[0] == "--num_devices":
        with pytest.raises(SystemExit, match="error: .*but only"):
            test_la.main(_flags(root, pth, tmp_path) + ["--device", "cpu"]
                         + flag)
        return
    for mod in (test_la, jax_test_la):
        monkeypatch.setattr(mod, "la_config", _f32(mod.la_config))
    jax_test_la.main(_flags(root, pth, tmp_path / "jax") + flag)
    test_la.main(_flags(root, pth, tmp_path / "port") + ["--device", "cpu"]
                 + flag)
    assert_same_dumps(tmp_path / "jax" / "LA_BCP_4_labeled" /
                      "VNet_predictions", tmp_path / "port" /
                      "LA_BCP_4_labeled" / "VNet_predictions",
                      ["%02d_%s.nii.gz" % (i, t) for i in range(2)
                       for t in ("gt", "img", "pred")])


def _f32(config):
    return lambda *a, **k: config(*a, **k).replace(compute_dtype="float32")


def assert_same_dumps(want_dir, got_dir, names, ties=None):
    """The two directories' NIfTI files are ``names``, with equal
    decompressed bytes (the gzip header carries a time). ``ties`` maps a
    file's name to a bool array, of the shape of the volume written, of
    the voxels where its data alone may differ: a prediction's argmax
    where the class scores are equal to float rounding, so that another
    summation order may pick the other class; its header must still be
    equal."""
    for d in (want_dir, got_dir):
        assert sorted(n for n in os.listdir(d) if n.endswith(".nii.gz")) \
            == sorted(names)
    for name in names:
        with gzip.open(got_dir / name) as g, gzip.open(want_dir / name) as w:
            got, want = g.read(), w.read()
        if ties is None or name not in ties:
            assert got == want, name
            continue
        # a single-file NIfTI-1: 348 header bytes, 4 extension bytes, data
        assert got[:352] == want[:352], name
        a = np.frombuffer(got[352:], np.float32)
        b = np.frombuffer(want[352:], np.float32)
        tie = ties[name].ravel()     # the writer's C-order bytes
        assert a.shape == b.shape == tie.shape, name
        assert np.array_equal(a[~tie], b[~tie]), name


def test_cli_without_checkpoint_errors(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        test_la.main(["--root_path", str(tmp_path), "--snapshot_root",
                      str(tmp_path), "--device", "cpu"])


def test_synthetic_volumes_equal_jax_generator(tmp_path):
    root = tmp_path / "port"
    synthetic.make_la_dataset(str(root), n_train=1, n_test=1,
                              shape=(12, 10, 9), seed=7)
    jax_synthetic.make_la_dataset(str(tmp_path / "jax"), n_train=1,
                                  n_test=1, shape=(12, 10, 9), seed=7)
    for split in ("train", "test"):
        a = LAHeartDataset(str(root), split).load(0)
        with h5py.File(os.path.join(
                tmp_path, "jax", "2018LA_Seg_Training Set",
                LAHeartDataset(str(root), split).cases[0],
                "mri_norm2.h5")) as f:
            b = (f["image"][:], f["label"][:])
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_vendored_split_lists_resolve(tmp_path):
    ds = LAHeartDataset(str(tmp_path), "test")
    assert len(ds) == 20 and ds.cases[0]


def test_port_imports_no_jax():
    """Every bcp_tpu_torch module, and chip_smoke.py, import without
    pulling in jax, flax, orbax or bcp_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import bcp_tpu_torch\n"
        "for m in pkgutil.walk_packages(bcp_tpu_torch.__path__, "
        "'bcp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'bcp_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('bcp_tpu_torch')]))\n"
        "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
