"""The port's grid, slab and bounding-box masks against ``bcp_tpu.ops.masks``:
the JAX draws replayed on the JAX side (``jax.random.split`` /
``randint``) and handed to the port as start offsets, bit for bit; the
trainer's ``mask_kind`` dispatch; the host-painted grid against the box
product."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcp_tpu.ops import masks as jax_masks
from bcp_tpu_torch.config import acdc_config, la_config
from bcp_tpu_torch.ops import masks
from bcp_tpu_torch.train.graphs import write_box
from bcp_tpu_torch.train.trainer import copy_paste_box, copy_paste_mask


def jax_grid_starts(key, spatial, shrink=3):
    """The start offsets ``masks.grid_mask`` draws from ``key``, cell by
    cell in its ``flat % shrink`` order."""
    ndim = len(spatial)
    cell = [d // shrink for d in spatial]
    sizes = masks.grid_sizes(spatial, shrink)
    extra = 1 if ndim == 3 else 0
    keys = jax.random.split(key, shrink ** ndim * ndim)
    out, k = [], 0
    for flat in range(shrink ** ndim):
        idx = [(flat // shrink ** d) % shrink for d in range(ndim)]
        starts = []
        for d in range(ndim):
            lo = idx[d] * cell[d]
            hi = (idx[d] + 1) * cell[d] - sizes[d] - extra
            starts.append(int(jax.random.randint(keys[k], (), lo, hi)))
            k += 1
        out.append(tuple(starts))
    return out


def jax_slab_start(key, spatial, axis, fraction):
    dim = spatial[axis]
    return int(jax.random.randint(key, (), 0, dim - int(dim * fraction) - 1))


@pytest.mark.parametrize("spatial,seed", [((16, 16, 16), 0),
                                          ((30, 27, 24), 1), ((32, 32), 2),
                                          ((40, 36), 3)])
def test_grid_mask_matches_jax_at_its_draws(spatial, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_masks.grid_mask(key, spatial))
    got = masks.grid_mask(spatial, jax_grid_starts(key, spatial))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spatial,axis,fraction,seed", [
    ((16, 16, 16), -1, 8 / 27, 0), ((30, 27, 24), -1, 8 / 27, 1),
    ((32, 32), 0, 4 / 9, 2), ((40, 36), 0, 4 / 9, 3)])
def test_slab_mask_matches_jax_at_its_draw(spatial, axis, fraction, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_masks.slab_mask(key, spatial, axis, fraction))
    got = masks.slab_mask(spatial, jax_slab_start(key, spatial, axis,
                                                  fraction), axis, fraction)
    np.testing.assert_array_equal(got.numpy(), want)


def test_numpy_draws_stay_in_the_jax_ranges():
    """``grid_starts`` / ``slab_start`` draw in JAX's [lo, hi) ranges, the
    3-D grid's and the slab's with the extra ``-1``; an empty range gives
    its minimum, as ``jax.random.randint`` does."""
    rng = np.random.default_rng(0)
    for spatial in ((112, 112, 80), (256, 256), (16, 16, 16)):
        sizes = masks.grid_sizes(spatial)
        cell = [d // 3 for d in spatial]
        extra = 1 if len(spatial) == 3 else 0
        for _ in range(5):
            for flat, st in enumerate(masks.grid_starts(rng, spatial)):
                for d, s in enumerate(st):
                    lo = ((flat // 3 ** d) % 3) * cell[d]
                    hi = lo + cell[d] - sizes[d] - extra
                    assert lo <= s < max(hi, lo + 1)
    assert masks.grid_sizes((112, 112, 80)) == (25, 25, 17)
    assert masks.grid_sizes((256, 256)) == (56, 56)
    for _ in range(20):
        assert 0 <= masks.slab_start(rng, (112, 112, 80)) < 80 - 23 - 1
        assert 0 <= masks.slab_start(rng, (256, 256), 0, 4 / 9) < 256 - 113 - 1


@pytest.mark.parametrize("case", ["blob", "empty", "corner"])
def test_bbox_matches_jax(case):
    rng = np.random.default_rng(5)
    m = np.zeros((3, 9, 8, 7), np.int32)
    if case == "blob":
        m[0, 2:5, 1:7, 3:4] = 1
        m[1] = rng.random((9, 8, 7)) > 0.97
        m[2, 8, 0, 6] = 2
    elif case == "corner":
        m[:, 0, 0, 0] = 1
    for one in m:
        np.testing.assert_array_equal(
            masks.bbox_nd(torch.from_numpy(one)).numpy(),
            np.asarray(jax_masks.bbox_nd(jnp.asarray(one))))
    np.testing.assert_array_equal(
        masks.bbox_mask(torch.from_numpy(m)).numpy(),
        np.asarray(jax_masks.bbox_mask(jnp.asarray(m))))


@pytest.mark.parametrize("kind,n_boxes", [("ratio", 1), ("grid", 27),
                                          ("slab", 1)])
def test_trainer_dispatch_and_static_write(kind, n_boxes):
    """``copy_paste_box`` gives one box, or 27 for a 3-D grid (9 in 2-D);
    the mask the trainer builds and the one ``write_box`` writes into a
    static buffer are the product of the boxes' masks."""
    cfg = la_config(patch_size=(30, 27, 24), mask_kind=kind)
    boxes = copy_paste_box(cfg, np.random.default_rng(3))
    assert len(boxes) == n_boxes
    want = torch.ones(cfg.patch_size, dtype=torch.int32)
    for starts, sizes in boxes:
        want *= masks.box_mask(cfg.patch_size, starts, sizes)
    got = copy_paste_mask(cfg, np.random.default_rng(3))
    assert torch.equal(got, want)
    buf = torch.full(cfg.patch_size, 7, dtype=torch.int32)
    assert torch.equal(write_box(buf, boxes), want)
    if kind == "slab":
        (starts, sizes), = boxes
        assert sizes == (30, 27, 7) and starts[:2] == (0, 0)
    acdc = acdc_config(patch_size=(32, 32), mask_kind=kind)
    boxes = copy_paste_box(acdc, np.random.default_rng(3))
    assert len(boxes) == (9 if kind == "grid" else 1)
    if kind == "slab":
        assert boxes[0][1] == (14, 32)
