"""The port's raw-format I/O and converters (``bcp_tpu_torch.data.
preprocess``) against ``bcp_tpu.data.preprocess``: the readers on the
NRRD / NIfTI files that ``tests/test_preprocess.py``'s writers make (raw
and gzip), the writer's bytes (an uncompressed ``.nii`` byte for byte, a
``.nii.gz`` decompressed: its gzip header carries a time), the LA and
ACDC converters' h5 contents, the CLI, and an import without ``h5py``."""

import gzip
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from bcp_tpu.data import preprocess as jax_pre
from bcp_tpu_torch.data import preprocess
from test_preprocess import write_nifti as ref_write_nifti
from test_preprocess import write_nrrd


@pytest.mark.parametrize("encoding", ["raw", "gzip"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_read_nrrd_matches_jax(tmp_path, encoding, dtype):
    arr = (np.random.default_rng(0).normal(size=(7, 6, 5)) * 40).astype(dtype)
    p = str(tmp_path / "x.nrrd")
    write_nrrd(p, arr, encoding)
    got, header = preprocess.read_nrrd(p)
    want, want_header = jax_pre.read_nrrd(p)
    assert got.dtype == want.dtype and header == want_header
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("name", ["x.nii", "x.nii.gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_read_nifti_matches_jax(tmp_path, name, dtype):
    arr = (np.random.default_rng(1).normal(size=(6, 5, 4)) * 40).astype(dtype)
    p = str(tmp_path / name)
    ref_write_nifti(p, arr)
    got = preprocess.read_nifti(p)
    want = jax_pre.read_nifti(p)
    assert got.dtype == want.dtype and got.shape == (4, 5, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["y.nii", "y.nii.gz"])
@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (1.0, 1.0, 10.0)])
def test_write_nifti_bytes_match_jax(tmp_path, name, spacing):
    """The bytes inside the file (decompressed for ``.gz``) are the JAX
    writer's, and read back to the array."""
    arr = np.random.default_rng(2).normal(size=(5, 6, 7)).astype(np.float32)
    got, want = str(tmp_path / ("port_" + name)), str(tmp_path / name)
    preprocess.write_nifti(got, arr, spacing=spacing)
    jax_pre.write_nifti(want, arr, spacing=spacing)

    def content(path):
        with open(path, "rb") as f:
            raw = f.read()
        return gzip.decompress(raw) if path.endswith(".gz") else raw
    assert content(got) == content(want)
    np.testing.assert_array_equal(preprocess.read_nifti(got), arr)


def _h5(path):
    with h5py.File(path) as f:
        return {k: f[k][:] for k in f}


def test_convert_la_matches_jax(tmp_path):
    """One seed, one case: the cropped, z-scored h5 equals the JAX
    converter's."""
    out = {}
    for side, fn in (("jax", jax_pre.convert_la),
                     ("port", preprocess.convert_la)):
        case_dir = tmp_path / side / "2018LA_Seg_Training Set" / "case0"
        os.makedirs(case_dir)
        rng = np.random.default_rng(2)
        img = rng.normal(size=(40, 36, 30)).astype(np.float32)
        lab = np.zeros((40, 36, 30), np.uint8)
        lab[12:25, 10:22, 8:20] = 255
        write_nrrd(str(case_dir / "lgemri.nrrd"), img)
        write_nrrd(str(case_dir / "laendo.nrrd"), lab, "gzip")
        assert fn(str(tmp_path / side), output_size=(16, 16, 12),
                  seed=5) == 1
        out[side] = _h5(case_dir / "mri_norm2.h5")
    assert sorted(out["port"]) == sorted(out["jax"]) == ["image", "label"]
    for k, v in out["port"].items():
        assert v.dtype == out["jax"][k].dtype
        np.testing.assert_array_equal(v, out["jax"][k])


def test_convert_acdc_matches_jax(tmp_path):
    image_dir = tmp_path / "image"
    os.makedirs(image_dir)
    os.makedirs(tmp_path / "label")
    rng = np.random.default_rng(3)
    for case in ("patient001", "patient002"):
        vol = rng.normal(size=(20, 18, 4)).astype(np.float32)
        ref_write_nifti(str(image_dir / f"{case}.nii.gz"), vol)
        ref_write_nifti(str(tmp_path / "label" / f"{case}_gt.nii.gz"),
                        (vol > 0.5).astype(np.uint8))
    n_port = preprocess.convert_acdc(str(image_dir), str(tmp_path / "port"))
    n_jax = jax_pre.convert_acdc(str(image_dir), str(tmp_path / "jax"))
    assert n_port == n_jax == 8
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        got, want = (_h5(tmp_path / d / name) for d in ("port", "jax"))
        for k, v in want.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)


def test_main_and_import_without_h5py(tmp_path, capsys):
    """``python -m bcp_tpu_torch.data.preprocess acdc`` prints the JAX
    CLI's lines; the module (readers and writer) imports and writes with
    ``h5py`` absent."""
    image_dir = tmp_path / "image"
    os.makedirs(image_dir)
    os.makedirs(tmp_path / "label")
    vol = np.random.default_rng(4).normal(size=(8, 8, 2)).astype(np.float32)
    ref_write_nifti(str(image_dir / "p.nii.gz"), vol)
    ref_write_nifti(str(tmp_path / "label" / "p_gt.nii.gz"),
                    (vol > 0).astype(np.uint8))
    preprocess.main(["acdc", "--image_dir", str(image_dir), "--output_dir",
                     str(tmp_path / "out")])
    assert capsys.readouterr().out.splitlines() == [
        "Converted all ACDC volumes to 2D slices", "Total 2 slices"]
    z = str(tmp_path / "z.nii.gz")
    code = ("import sys; sys.modules['h5py'] = None\n"
            "import numpy as np\n"
            "from bcp_tpu_torch.data import preprocess as p\n"
            f"p.write_nifti({z!r}, np.ones((2, 3, 4)))\n"
            f"print(p.read_nifti({z!r}).sum())\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["24.0"]
