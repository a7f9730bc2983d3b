"""The port's overlap-add against the in-order numpy loop of
``tests/test_scatter_pallas.py``: equal bit for bit."""

import numpy as np
import pytest
import torch

from bcp_tpu_torch.ops.scatter import (scatter_add_windows,
                                       scatter_add_windows_reference)


def _case(seed, X=40, Y=36, Z=28, C=2, B=6, p=(16, 12, 8)):
    rng = np.random.default_rng(seed)
    score = rng.random((X, Y, Z, C)).astype(np.float32)
    probs = rng.random((B, *p, C)).astype(np.float32)
    # overlapping windows, some repeated
    starts = np.stack([rng.integers(0, X - p[0] + 1, B),
                       rng.integers(0, Y - p[1] + 1, B),
                       rng.integers(0, Z - p[2] + 1, B)], 1).astype(np.int32)
    starts[-1] = starts[0]
    return score, probs, starts


def _numpy_loop(score, probs, starts):
    want = score.copy()
    px, py, pz = probs.shape[1:4]
    for w in range(len(starts)):
        sx, sy, sz = starts[w]
        want[sx:sx + px, sy:sy + py, sz:sz + pz] += probs[w]
    return want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_overlap_add_equals_numpy_loop(seed):
    score, probs, starts = _case(seed)
    got = torch.from_numpy(score.copy())
    before = scatter_add_windows.launches
    out = scatter_add_windows(got, torch.from_numpy(probs), starts)
    assert out is got and scatter_add_windows.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  _numpy_loop(score, probs, starts))


def test_starts_may_be_a_host_tensor():
    score, probs, starts = _case(5)
    a = torch.from_numpy(score.copy())
    scatter_add_windows_reference(a, torch.from_numpy(probs),
                                  torch.from_numpy(starts))
    np.testing.assert_array_equal(a.numpy(),
                                  _numpy_loop(score, probs, starts))


def test_window_outside_the_map_raises():
    score, probs, starts = _case(0)
    starts[0, 0] = score.shape[0] - probs.shape[1] + 1
    with pytest.raises(ValueError, match="outside"):
        scatter_add_windows(torch.from_numpy(score), torch.from_numpy(probs),
                            starts)
