"""The port's LA host feed against the JAX package's ``BCPBatchFeeder``
(host path): the same seed gives the same batches bit for bit."""

import numpy as np
import pytest
import torch

from bcp_tpu.config import la_config as jax_la_config
from bcp_tpu.data import synthetic as jax_synthetic
from bcp_tpu.data.feed import BCPBatchFeeder as JaxFeeder
from bcp_tpu.data.sampler import two_stream_batches as jax_two_stream
from bcp_tpu.data.transforms import la_train_transform as jax_transform
from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.data.datasets import LAHeartDataset, VolumeList
from bcp_tpu_torch.data.feed import BCPBatchFeeder
from bcp_tpu_torch.data.sampler import two_stream_batches
from bcp_tpu_torch.data.synthetic import la_cases
from bcp_tpu_torch.data.transforms import la_train_transform


@pytest.fixture(scope="module")
def la_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("la_feed")
    jax_synthetic.make_la_dataset(str(root), n_train=8, n_test=1,
                                  shape=(22, 20, 18), seed=11)
    return str(root)


def _cfgs(root, dtype):
    kw = dict(root_path=root, labelnum=4, patch_size=(16, 16, 12),
              compute_dtype=dtype, device_data_cache=False)
    return jax_la_config(**kw), la_config(**kw)


@pytest.mark.parametrize("stage,dtype", [("pre", "float32"),
                                         ("self", "float32"),
                                         ("self", "bfloat16")])
def test_feed_batches_equal_jax_feeder(la_root, stage, dtype):
    jcfg, cfg = _cfgs(la_root, dtype)
    want_feed = JaxFeeder(jcfg, stage)
    got_feed = BCPBatchFeeder(cfg, stage,
                              LAHeartDataset(la_root, "train", cache=True),
                              device="cpu")
    try:
        for _ in range(5):      # crosses an epoch (one batch per epoch)
            want = {k: np.asarray(v) for k, v in next(want_feed).items()}
            got = next(got_feed)
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                w = want[k]
                if k.startswith(("img", "uimg")):
                    w = np.moveaxis(w, -1, 1)   # NDHWC -> NCDHW
                    assert v.dtype == (torch.bfloat16 if dtype == "bfloat16"
                                       else torch.float32)
                    v = v.float()
                np.testing.assert_array_equal(v.numpy(),
                                              w.astype(v.numpy().dtype),
                                              err_msg=k)
    finally:
        want_feed.close()
        got_feed.close()


def test_sampler_and_transform_match_jax():
    a = two_stream_batches(range(4), range(4, 10), 8, 4, seed=3)
    b = jax_two_stream(range(4), range(4, 10), 8, 4, seed=3)
    for _ in range(7):
        assert next(a) == next(b)
    image, label = la_cases(1, (20, 18, 17), seed=2)[0]
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        gi, gl = la_train_transform(image, label, (16, 16, 16), r1)
        wi, wl = jax_transform(image, label, (16, 16, 16), r2)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_volume_list_feeds_without_h5():
    cfg = la_config(labelnum=4, patch_size=(8, 8, 8), compute_dtype="float32")
    feed = BCPBatchFeeder(cfg, "self", VolumeList(la_cases(8, (10, 9, 9))),
                          device="cpu")
    try:
        batch = next(feed)
    finally:
        feed.close()
    assert batch["img_a"].shape == (2, 1, 8, 8, 8)
    assert batch["uimg_b"].shape == (2, 1, 8, 8, 8)
    assert batch["lab_b"].dtype == torch.uint8
