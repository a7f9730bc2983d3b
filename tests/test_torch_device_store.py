"""The port's device-resident volume store and the feeder's
``device_data_cache`` path against the JAX package's, on the CPU: the same
seed gives the same crops and batches bit for bit (crop, rot90 and flip
only move values; the draws consume the numpy generator in one order).
`tests/test_device_store.py:38-96` shows the JAX package's own cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcp_tpu.config import la_config as jax_la_config
from bcp_tpu.data import synthetic as jax_synthetic
from bcp_tpu.data.device_store import DeviceVolumeStore as JaxStore
from bcp_tpu.data.feed import BCPBatchFeeder as JaxFeeder
from bcp_tpu.data.transforms import center_crop as jax_center_crop
from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.data.datasets import LAHeartDataset, VolumeList
from bcp_tpu_torch.data.device_store import DeviceVolumeStore
from bcp_tpu_torch.data.feed import BCPBatchFeeder
from bcp_tpu_torch.data.synthetic import la_cases

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _volumes(n=3, shape=(30, 28, 20), seed=0):
    rng = np.random.default_rng(seed)
    imgs = [rng.normal(size=shape).astype(np.float32) for _ in range(n)]
    labs = [(rng.random(shape) > 0.7).astype(np.uint8) for _ in range(n)]
    return imgs, labs


def _stores(imgs, labs, patch, pad_extra, dtype):
    tdt, jdt = DTYPES[dtype]
    return (DeviceVolumeStore(imgs, labs, patch, pad_extra, tdt, "cpu"),
            JaxStore(imgs, labs, patch, pad_extra, jdt))


def _equal(got_img, got_lab, want_img, want_lab):
    """Port (N, 1, *S) / (N, *S) against JAX (N, *S, 1) / (N, *S)."""
    want = np.moveaxis(np.asarray(want_img.astype(jnp.float32)), -1, 1)
    np.testing.assert_array_equal(got_img.float().numpy(), want)
    assert got_lab.dtype == torch.uint8
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rotflip", [True, False])
def test_sample_batch_equals_jax_store(dtype, rotflip):
    imgs, labs = _volumes(shape=(20, 22, 16))
    got, want = _stores(imgs, labs, (12, 12, 8), 1, dtype)
    np.testing.assert_array_equal(got.shapes, want.shapes)
    assert got.images.shape == tuple(want.images.shape)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for idx in ([0, 1], [2, 2, 1, 0]):       # 8 rot/flip draws in all
        gi, gl = got.sample_batch(idx, r1, rotflip=rotflip)
        wi, wl = want.sample_batch(idx, r2, rotflip=rotflip)
        assert gi.dtype == DTYPES[dtype][0]
        assert gi.shape == (len(idx), 1, 12, 12, 8)
        _equal(gi, gl, wi, wl)
    assert r1.integers(1 << 30) == r2.integers(1 << 30)   # same draws used


def test_every_rot_and_flip_equals_jax_store():
    imgs, labs = _volumes(n=1, shape=(14, 14, 9))
    got, want = _stores(imgs, labs, (10, 10, 6), 3, "float32")
    for k in range(4):
        for f in range(2):
            params = (np.array([0], np.int32), np.array([[2, 1, 3]], np.int32),
                      np.array([k], np.int32), np.array([f], np.int32))
            _equal(*got.crop_batch(params), *want.crop_batch(params))


def test_center_batch_matches_host_center_crop_and_jax_store():
    imgs, labs = _volumes()
    patch = (16, 16, 16)
    got, want = _stores(imgs, labs, patch, 1, "float32")
    gi, gl = got.center_batch([0, 1, 2])
    _equal(gi, gl, *want.center_batch([0, 1, 2]))
    for i in range(3):
        wi, wl = jax_center_crop(imgs[i], labs[i], patch, pad_extra=1)
        np.testing.assert_allclose(gi[i, 0].numpy(), wi, rtol=1e-6)
        np.testing.assert_array_equal(gl[i].numpy(), wl)


def test_pad_if_small_and_no_rotflip_is_a_crop():
    imgs, labs = _volumes(shape=(10, 10, 6))
    store = DeviceVolumeStore(imgs, labs, (16, 16, 16), pad_extra=3,
                              img_dtype=torch.float32, device="cpu")
    img, lab = store.center_batch([0])
    assert img.shape == (1, 1, 16, 16, 16) and lab.shape == (1, 16, 16, 16)
    assert tuple(store.shapes[0]) == (22, 22, 22)   # (16-10)//2+3, (16-6)//2+3
    imgs, labs = _volumes()
    store = DeviceVolumeStore(imgs, labs, (16, 16, 16), pad_extra=1,
                              img_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    idx, offsets, ks, flips = store.draw_params([1], rng, rotflip=False)
    assert ks[0] == 0 and flips[0] == 0
    ox, oy, oz = offsets[0]
    crop = store.crop_batch((idx, offsets, ks, flips), rotflip=False)[0]
    np.testing.assert_array_equal(
        crop[0, 0].numpy(), imgs[1][ox:ox + 16, oy:oy + 16, oz:oz + 16])


def test_rot90_refuses_a_non_square_patch():
    imgs, labs = _volumes()
    store = DeviceVolumeStore(imgs, labs, (16, 12, 8), img_dtype=None,
                              device="cpu")
    with pytest.raises(ValueError, match="square"):
        store.sample_batch([0], np.random.default_rng(0))


@pytest.fixture(scope="module")
def la_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("la_store")
    jax_synthetic.make_la_dataset(str(root), n_train=8, n_test=1,
                                  shape=(22, 20, 18), seed=11)
    return str(root)


@pytest.mark.parametrize("stage,dtype", [("pre", "float32"),
                                         ("self", "float32"),
                                         ("self", "bfloat16")])
def test_device_cache_feed_equals_jax_feeder(la_root, stage, dtype):
    kw = dict(root_path=la_root, labelnum=4, patch_size=(16, 16, 12),
              compute_dtype=dtype, device_data_cache=True)
    want_feed = JaxFeeder(jax_la_config(**kw), stage)
    got_feed = BCPBatchFeeder(la_config(**kw), stage,
                              LAHeartDataset(la_root, "train", cache=True),
                              device="cpu")
    try:
        assert got_feed.steps_per_epoch == want_feed.steps_per_epoch
        for _ in range(5):
            want = {k: np.asarray(v.astype(jnp.float32)
                                  if v.dtype == jnp.bfloat16 else v)
                    for k, v in next(want_feed).items()}
            got = next(got_feed)
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                w = want[k]
                if k.startswith(("img", "uimg")):
                    w = np.moveaxis(w, -1, 1)   # NDHWC -> NCDHW
                    assert v.dtype == DTYPES[dtype][0]
                    v = v.float()
                else:
                    assert v.dtype == torch.uint8
                np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
    finally:
        want_feed.close()
        got_feed.close()


def test_stages_share_one_store_and_start_no_thread():
    cfg = la_config(labelnum=4, patch_size=(8, 8, 8),
                    compute_dtype="float32", device_data_cache=True)
    data = VolumeList(la_cases(8, (10, 9, 9)))
    cache = {}
    pre = BCPBatchFeeder(cfg, "pre", data, device="cpu", store_cache=cache)
    self_ = BCPBatchFeeder(cfg, "self", data, device="cpu", store_cache=cache)
    assert pre._store is self_._store is cache["store"]
    assert pre._thread is None and self_._thread is None
    batch = next(self_)
    assert batch["img_a"].shape == (2, 1, 8, 8, 8)
    assert batch["uimg_b"].shape == (2, 1, 8, 8, 8)
    assert "uimg_a" not in next(pre)
    pre.close(), self_.close()
    other = BCPBatchFeeder(cfg, "pre", data, device="cpu")
    assert other._store is not cache["store"]
