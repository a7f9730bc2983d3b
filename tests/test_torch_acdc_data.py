"""The ACDC slice's data path against the JAX package: the transforms, the
dataset reader, the host feed's batches (bit for bit, same seed), and the
device slice store (bit-exact to scipy in its none and rot90 + flip modes
and its zoom, its f32 rotate mode under 1e-3 of the pixels, and equal to
the JAX store's batches from the same draws)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from bcp_tpu.config import acdc_config as jax_acdc_config
from bcp_tpu.data import feed as jax_feed
from bcp_tpu.data import synthetic as jax_synthetic
from bcp_tpu.data import transforms as jax_transforms
from bcp_tpu.data.datasets import ACDCDataset as JaxACDCDataset
from bcp_tpu.data.device_store import DeviceSliceStore as JaxSliceStore
from bcp_tpu.data.feed import BCPBatchFeeder as JaxFeeder
from bcp_tpu_torch.config import acdc_config
from bcp_tpu_torch.data import feed, transforms
from bcp_tpu_torch.data.datasets import ACDCDataset, SliceList
from bcp_tpu_torch.data.device_store import DeviceSliceStore
from bcp_tpu_torch.data.feed import BCPBatchFeeder
from bcp_tpu_torch.data.synthetic import acdc_cases

OUT = (32, 32)
# in-plane shapes of the stores' slices: non-square, swapped, square,
# thin, and larger than OUT on one side only
SHAPES = [(37, 53), (53, 37), (40, 40), (64, 17), (28, 45)]


def test_transforms_match_jax():
    slices, _ = acdc_cases(6, SHAPES, seed=1)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        for img, lab in slices:
            gi, gl = transforms.acdc_random_generator(img, lab, OUT, r1)
            wi, wl = jax_transforms.acdc_random_generator(img, lab, OUT, r2)
            assert gi.dtype == np.float32 and gl.dtype == np.uint8
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    img, lab = slices[0]
    for fn, args in ((transforms.random_rotate, (np.random.default_rng(4),)),
                     (transforms.zoom_to, ((24, 40),))):
        want = getattr(jax_transforms, fn.__name__)(
            img, lab, *[np.random.default_rng(4) if isinstance(
                a, np.random.Generator) else a for a in args])
        for g, w in zip(fn(img, lab, *args), want):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def acdc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_data")
    jax_synthetic.make_acdc_dataset(str(root), n_train_slices=20, n_val=2,
                                    slice_shape=(40, 36), vol_depth=3,
                                    seed=11)
    return str(root)


def test_dataset_reads_the_jax_layout(acdc_root, tmp_path):
    for split in ("train", "val", "test"):
        got, want = ACDCDataset(acdc_root, split), JaxACDCDataset(
            acdc_root, split, cache=False)
        assert got.cases == want.cases and len(got) == len(want)
        for g, w in zip(got.load(1), want.load(1)):
            np.testing.assert_array_equal(g, w)
    assert ACDCDataset(acdc_root, "train", num=5).cases == JaxACDCDataset(
        acdc_root, "train", num=5, cache=False).cases
    # no lists under the root: the port's copies of the reference's splits
    counts = {s: len(ACDCDataset(str(tmp_path), s).cases)
              for s in ("train", "val", "test")}
    assert counts == {"train": 1312, "val": 20, "test": 40}
    assert len(ACDCDataset(str(tmp_path), "train", num=136)) == 136


def test_synthetic_dataset_equals_jax_generator(tmp_path):
    from bcp_tpu_torch.data.synthetic import make_acdc_dataset
    got = make_acdc_dataset(str(tmp_path / "port"), 3, 1, (20, 24), 2)
    want = jax_synthetic.make_acdc_dataset(str(tmp_path / "jax"), 3, 1,
                                           (20, 24), 2)
    for split in ("train", "val"):
        g, w = ACDCDataset(got, split), ACDCDataset(want, split)
        assert g.cases == w.cases
        for i in range(len(g)):
            for a, b in zip(g.load(i), w.load(i)):
                np.testing.assert_array_equal(a, b)


@pytest.fixture
def eight_labelled(monkeypatch):
    """labelnum 1 means the first 8 slices on both sides (the synthetic
    set has 20)."""
    monkeypatch.setitem(jax_feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    monkeypatch.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)


def _host(v):
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                      else v)


@pytest.mark.parametrize("stage,dtype,store", [
    ("pre", "float32", False), ("self", "float32", False),
    ("self", "bfloat16", False), ("pre", "float32", True),
    ("self", "bfloat16", True)])
def test_feed_batches_equal_jax_feeder(acdc_root, eight_labelled, stage,
                                       dtype, store):
    """Host path bit for bit; device store equal to the JAX store's feed
    (the same draws, the same gathers)."""
    kw = dict(root_path=acdc_root, labelnum=1, patch_size=OUT, batch_size=8,
              labeled_bs=4, compute_dtype=dtype, device_data_cache=store)
    want_feed = JaxFeeder(jax_acdc_config(**kw), stage)
    got_feed = BCPBatchFeeder(acdc_config(**kw), stage,
                              ACDCDataset(acdc_root, "train", cache=True),
                              device="cpu")
    try:
        assert got_feed.steps_per_epoch == want_feed.steps_per_epoch == 2
        for _ in range(5):      # crosses two epochs
            want = {k: _host(v) for k, v in next(want_feed).items()
                    if not k.startswith("ulab")}
            got = next(got_feed)
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                w = want[k]
                if k.startswith(("img", "uimg")):
                    w = np.moveaxis(w, -1, 1)   # NHWC -> NCHW
                    assert v.dtype == (torch.bfloat16 if dtype == "bfloat16"
                                       else torch.float32)
                    v = v.float()
                else:
                    assert v.dtype == torch.uint8
                np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
    finally:
        want_feed.close()
        got_feed.close()


def _slices(seed=0, reps=1):
    rng = np.random.default_rng(seed)
    shapes = SHAPES * reps
    return ([rng.random(s).astype(np.float32) for s in shapes],
            [rng.integers(0, 4, s).astype(np.uint8) for s in shapes])


def _scipy(img, lab, mode, k, flip, angle):
    """The host transform with the draws forced (the oracle)."""
    if mode == 1:
        img, lab = np.rot90(img, k), np.rot90(lab, k)
        img, lab = np.flip(img, axis=flip), np.flip(lab, axis=flip)
    elif mode == 2:
        img = ndimage.rotate(img, angle, order=0, reshape=False)
        lab = ndimage.rotate(lab, angle, order=0, reshape=False)
    return transforms.zoom_to(img, lab, OUT)


def test_store_none_and_rotflip_modes_are_scipy_bit_for_bit():
    imgs, labs = _slices()
    store = DeviceSliceStore(imgs, labs, OUT, img_dtype=torch.float32,
                             device="cpu")
    cases = [(i, 0, 0, 0) for i in range(len(imgs))]
    cases += [(i, 1, k, f) for i in range(len(imgs)) for k in range(4)
              for f in range(2)]
    params = tuple(np.array(c, np.int32) for c in zip(*cases)) + (
        np.zeros(len(cases), np.int32),)
    got_img, got_lab = store.aug_batch(params)
    assert got_img.shape == (len(cases), 1, *OUT)
    for n, (i, m, k, f) in enumerate(cases):
        want_img, want_lab = _scipy(imgs[i], labs[i], m, k, f, 0)
        np.testing.assert_array_equal(got_img[n, 0].numpy(), want_img)
        np.testing.assert_array_equal(got_lab[n].numpy(), want_lab)


def test_store_rotate_mode_within_the_f32_limit():
    """f32 source coordinates where scipy uses f64: under 1e-3 of the
    pixels may take a neighbour (the JAX store's own limit)."""
    imgs, labs = _slices(seed=3, reps=8)
    store = DeviceSliceStore(imgs, labs, OUT, img_dtype=torch.float32,
                             device="cpu")
    n = len(imgs)
    angles = np.random.default_rng(5).integers(-20, 20, n).astype(np.int32)
    zeros = np.zeros(n, np.int32)
    got_img, got_lab = store.aug_batch(
        (np.arange(n, dtype=np.int32), np.full(n, 2, np.int32), zeros,
         zeros, angles))
    wrong = total = 0
    for j in range(n):
        want_img, want_lab = _scipy(imgs[j], labs[j], 2, 0, 0, angles[j])
        wrong += (got_img[j, 0].numpy() != want_img).sum()
        wrong += (got_lab[j].numpy() != want_lab).sum()
        total += 2 * want_img.size
    assert wrong / total < 1e-3, f"{wrong}/{total} pixels differ"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_equals_jax_store_from_the_same_draws(dtype):
    """Equal draws from one seed; the none and rot90 + flip samples equal
    bit for bit, the rotate samples within 1e-3 of their pixels (both
    compute its coordinates in f32)."""
    imgs, labs = _slices(seed=6, reps=6)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32" else
                (jnp.bfloat16, torch.bfloat16))
    want_store = JaxSliceStore(imgs, labs, OUT, img_dtype=jdt)
    got_store = DeviceSliceStore(imgs, labs, OUT, img_dtype=tdt,
                                 device="cpu")
    idx = np.random.default_rng(7).integers(0, len(imgs), 40)
    got_p = got_store.draw_params(idx, np.random.default_rng(8))
    want_p = want_store.draw_params(idx, np.random.default_rng(8))
    for g, w in zip(got_p, want_p):
        np.testing.assert_array_equal(g, w)
    modes = got_p[1]
    assert set(modes) == {0, 1, 2}
    got_img, got_lab = got_store.aug_batch(got_p)
    want_img, want_lab = want_store.aug_batch(want_p)
    assert got_img.dtype == tdt and got_lab.dtype == torch.uint8
    gi = got_img[:, 0].float().numpy()
    wi = _host(want_img)[..., 0]
    gl, wl = got_lab.numpy(), np.asarray(want_lab)
    exact = modes != 2
    np.testing.assert_array_equal(gi[exact], wi[exact])
    np.testing.assert_array_equal(gl[exact], wl[exact])
    assert ((gi != wi)[~exact].mean() + (gl != wl)[~exact].mean()) < 1e-3


def test_slice_list_feeds_without_h5_and_stages_share_the_store(
        eight_labelled):
    slices, _ = acdc_cases(12, SHAPES, seed=2)
    cfg = acdc_config(labelnum=1, patch_size=OUT, batch_size=8,
                      labeled_bs=4, compute_dtype="float32")
    assert cfg.device_data_cache is False
    host = BCPBatchFeeder(cfg, "self", SliceList(slices), device="cpu")
    try:
        batch = next(host)
    finally:
        host.close()
    assert batch["img_a"].shape == (2, 1, *OUT)
    assert batch["uimg_b"].shape == (2, 1, *OUT)
    assert batch["lab_b"].dtype == torch.uint8
    cache = {}
    cfg = cfg.replace(device_data_cache=True)
    pre = BCPBatchFeeder(cfg, "pre", SliceList(slices), device="cpu",
                         store_cache=cache)
    self_ = BCPBatchFeeder(cfg, "self", SliceList(slices), device="cpu",
                           store_cache=cache)
    assert pre._store is self_._store is cache["store"]
    assert isinstance(cache["store"], DeviceSliceStore)
    assert next(self_)["uimg_a"].shape == (2, 1, *OUT)
    assert feed.labeled_count(cfg) == 8
