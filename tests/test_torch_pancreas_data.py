"""The pancreas slice's data path against the JAX package: the centre crop
and the two transforms, the dataset reader (lists, ``oversample``,
``reverse``), the in-memory lists, the synthetic generator, and the four
zipped streams of the feed, host path and device store, batch for batch
bit for bit at 10 % and 20 % labelled (same seed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcp_tpu.config import pancreas_config as jax_pancreas_config
from bcp_tpu.data import synthetic as jax_synthetic
from bcp_tpu.data import transforms as jax_transforms
from bcp_tpu.data.datasets import PancreasDataset as JaxPancreasDataset
from bcp_tpu.data.feed import BCPBatchFeeder as JaxFeeder
from bcp_tpu_torch.config import pancreas_config
from bcp_tpu_torch.data import transforms
from bcp_tpu_torch.data.datasets import PancreasDataset, PancreasList
from bcp_tpu_torch.data.feed import BCPBatchFeeder, pancreas_steps_per_epoch
from bcp_tpu_torch.data.synthetic import (make_pancreas_dataset,
                                          pancreas_cases)

PATCH = (16, 16, 16)
# a volume larger than the patch on every side, one equal to it on one
# side, one smaller on one side, one with odd margins (a centre start of
# x.5 rounds half to even)
SHAPES = [(24, 20, 18), (16, 22, 19), (20, 13, 18), (21, 23, 17)]


def test_transforms_match_jax():
    cases, _, _ = pancreas_cases(8, 0, 0, SHAPES, seed=1)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for img, lab in cases:
        for fn in ("pancreas_train_transform", "pancreas_test_transform"):
            extra = (r1,) if fn.endswith("train_transform") else ()
            wextra = (r2,) if extra else ()
            got = getattr(transforms, fn)(img, lab, PATCH, *extra)
            want = getattr(jax_transforms, fn)(img, lab, PATCH, *wextra)
            assert got[0].shape == PATCH
            assert got[0].dtype == np.float32 and got[1].dtype == np.int32
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        for extra in (1, 3):
            for g, w in zip(transforms.center_crop(img, lab, PATCH, extra),
                            jax_transforms.center_crop(img, lab, PATCH,
                                                       extra)):
                np.testing.assert_array_equal(g, w)


def test_centre_start_rounds_half_to_even():
    img = np.arange(21 * 17 * 16, dtype=np.float32).reshape(21, 17, 16)
    got, _ = transforms.center_crop(img, img, PATCH)
    # margins 5 and 1: round(2.5) == 2 and round(0.5) == 0
    np.testing.assert_array_equal(got, img[2:18, 0:16, 0:16])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("pancreas_data")
    return jax_synthetic.make_pancreas_dataset(
        str(path), n_lab=4, n_unlab=6, n_test=2, shape=(20, 14, 18), seed=5)


@pytest.mark.parametrize("split,oversample,reverse", [
    ("train_lab", 5, False), ("train_lab", 10, True),
    ("train_unlab", 1, False), ("train_unlab", 1, True), ("test", 1, False)])
def test_dataset_matches_jax(root, split, oversample, reverse):
    got = PancreasDataset(root, split, oversample=oversample,
                          reverse=reverse)
    want = JaxPancreasDataset(root, split, oversample=oversample,
                              reverse=reverse, cache=False)
    assert got.rel_paths == want.rel_paths
    assert len(got) == len(want) == len(want.rel_paths) * oversample
    for i in range(len(got)):
        assert got.case_path(i) == want.case_path(i)
    for i in (0, len(got) - 1):
        for g, w in zip(got.load(i), want.load(i)):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got.sample_train(i, PATCH, np.random.default_rng(i)),
                        want.sample_train(i, PATCH,
                                          np.random.default_rng(i))):
            np.testing.assert_array_equal(g, w)


def test_in_memory_list_reads_like_the_dataset(root):
    ds = PancreasDataset(root, "train_lab")
    cases = [ds.load_raw(i) for i in range(ds.n_raw)]
    for oversample, reverse in ((1, False), (5, True), (10, False)):
        got = PancreasList(cases).variant(oversample, reverse)
        want = ds.variant(oversample, reverse)
        assert len(got) == len(want)
        for i in range(len(got)):
            assert got.raw_index(i) == want.raw_index(i)
            assert got.load(i)[0] is want.load(i)[0]
    # a variant shares its source's read cache
    assert ds.variant(5, True)._cache is ds._cache


def test_synthetic_dataset_equals_jax_generator(tmp_path):
    got = make_pancreas_dataset(str(tmp_path / "port"), 2, 3, 1, (12, 10, 9),
                                seed=2)
    want = jax_synthetic.make_pancreas_dataset(str(tmp_path / "jax"), 2, 3,
                                               1, (12, 10, 9), seed=2)
    for split in ("train_lab", "train_unlab", "test"):
        g, w = PancreasDataset(got, split), PancreasDataset(want, split)
        assert g.rel_paths == w.rel_paths
        for i in range(len(g)):
            for a, b in zip(g.load(i), w.load(i)):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)


def _host(v):
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                      else v)


@pytest.mark.parametrize("percent", [10, 20])
@pytest.mark.parametrize("stage,dtype,store", [
    ("pre", "float32", False), ("self", "float32", False),
    ("self", "bfloat16", False), ("pre", "bfloat16", True),
    ("self", "float32", True), ("self", "bfloat16", True)])
def test_feed_batches_equal_jax_feeder(root, percent, stage, dtype, store):
    """The four streams, host path and device store, against the JAX
    feeder on the same h5 files, over more than one epoch."""
    kw = dict(root_path=root, patch_size=PATCH, compute_dtype=dtype,
              device_data_cache=store)
    want_feed = JaxFeeder(jax_pancreas_config(percent, **kw), stage)
    cfg = pancreas_config(percent, **kw)
    lists = (PancreasDataset(root, "train_lab"),
             PancreasDataset(root, "train_unlab"))
    cache = {}
    got_feed = BCPBatchFeeder(cfg, stage, lists, device="cpu",
                              store_cache=cache)
    try:
        oversample = 5 if percent == 20 else 10
        per_epoch = (4 * oversample // 2 if stage == "pre" else 3)
        assert got_feed.steps_per_epoch == want_feed.steps_per_epoch \
            == pancreas_steps_per_epoch(cfg, stage, lists) == per_epoch
        # the pre stage does not build the unlabelled store
        assert sorted(cache) == ([] if not store else ["lab"] if
                                 stage == "pre" else ["lab", "unlab"])
        for _ in range(4 if stage == "self" else 2):
            want = {k: _host(v) for k, v in next(want_feed).items()}
            got = next(got_feed)
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                w = want[k]
                if k.startswith(("img", "uimg")):
                    w = np.moveaxis(w, -1, 1)   # NDHWC -> NCDHW
                    assert v.dtype == (torch.bfloat16 if dtype == "bfloat16"
                                       else torch.float32)
                    v = v.float()
                else:
                    assert v.dtype == torch.uint8
                np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
    finally:
        want_feed.close()
        got_feed.close()


def test_streams_pair_forward_and_reversed_volumes():
    """lab_b and unlab_b are the reversed streams of the same lists, not
    second draws: with 3 labelled volumes oversampled x5 and batches of
    2, stream index i is raw volume i % 3 in lab_a and 2 - i % 3 in
    lab_b."""
    lab = [(np.full((16, 16, 16), float(i), np.float32),
            np.zeros((16, 16, 16), np.float32)) for i in range(3)]
    unlab = [(np.full((16, 16, 16), 10.0 + i, np.float32),
              np.zeros((16, 16, 16), np.float32)) for i in range(4)]
    cfg = pancreas_config(patch_size=PATCH, compute_dtype="float32")
    for store in (False, True):
        feeder = BCPBatchFeeder(
            cfg.replace(device_data_cache=store), "self",
            (PancreasList(lab), PancreasList(unlab, "train_unlab")),
            device="cpu")
        seen = []
        try:
            for _ in range(3):
                b = next(feeder)
                seen.append({k: b[k][:, 0, 8, 8, 8].tolist()
                             for k in ("img_a", "img_b", "uimg_a",
                                       "uimg_b")})
        finally:
            feeder.close()
        assert feeder.steps_per_epoch == 2      # min(15 // 2, 4 // 2)
        assert [s["img_a"] for s in seen] == [[0, 1], [2, 0], [0, 1]]
        assert [s["img_b"] for s in seen] == [[2, 1], [0, 2], [2, 1]]
        assert [s["uimg_a"] for s in seen] == [[10, 11], [12, 13], [10, 11]]
        assert [s["uimg_b"] for s in seen] == [[13, 12], [11, 10], [13, 12]]
