"""The port's copy of ``bcp_tpu/utils/statistic.py`` against the JAX
package's module on the same seeded arrays: every function, equal
results."""

import numpy as np
import pytest

from bcp_tpu.utils import statistic as jax_stat
from bcp_tpu_torch.utils import statistic


def _masks(seed, shape=(3, 6, 7, 5), classes=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, classes, shape).astype(np.uint8),
            rng.integers(0, classes, shape).astype(np.uint8))


def _equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,args", [
    ("dice_ratio", ()), ("dice_loss_score", ()), ("accuracy", ()),
    ("precision_recall", ()), ("acc", ()), ("pre_rec", ()),
    ("smooth_dice", ()), ("smooth_dice", (1,)), ("cal_dice", (2,))])
def test_binary_functions_equal_jax(name, args, seed):
    m, l = _masks(seed)
    _equal(getattr(statistic, name)(m, l, *args),
           getattr(jax_stat, name)(m, l, *args))


@pytest.mark.parametrize("seed", [0, 3])
def test_dice_per_sample_flavours_equal_jax(seed):
    m, l = _masks(seed, classes=4)
    _equal(statistic.dice_loss_score(m, l, is_average=False),
           jax_stat.dice_loss_score(m, l, is_average=False))
    _equal(statistic.dice_mc(m, l, 4), jax_stat.dice_mc(m, l, 4))
    got, want = statistic.dice_m(m, l, 3), jax_stat.dice_m(m, l, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])   # NaNs in one place
    _equal(statistic.cal_dice(m, l, 4), jax_stat.cal_dice(m, l, 4))


def test_mask_pair_functions_equal_jax():
    m, l = _masks(5)
    con, _ = _masks(6)
    _equal(statistic.acc_test(m, l, con), jax_stat.acc_test(m, l, con))
    _equal(statistic.acc_m(m, l, con), jax_stat.acc_m(m, l, con))


def test_hausdorff_equals_jax():
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(12, 3)), rng.normal(size=(9, 3))
    assert statistic.hausdorff_mad_distance(a, b) == \
        jax_stat.hausdorff_mad_distance(a, b)
    assert statistic.hausdorff_mad_distance([], b, 5.0) == 5.0
