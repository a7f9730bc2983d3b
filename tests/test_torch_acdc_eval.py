"""The per-slice evaluator against the JAX package's ``Slice2DEvaluator``
on two synthetic volumes whose in-plane shapes are not the net's (one zoom
in, one zoom out per axis), from the same converted weights in f32: the
label volumes are equal, and so are ``metrics_for`` and
``validate_volumes``."""

import numpy as np
import pytest
import torch

from bcp_tpu.eval.slice2d import Slice2DEvaluator as JaxEvaluator
from bcp_tpu_torch.data.synthetic import acdc_cases
from bcp_tpu_torch.eval.slice2d import Slice2DEvaluator
from torch_port_helpers import flax_unet_variables, port_unet

PATCH = (32, 32)


@pytest.fixture(scope="module")
def pair():
    model, variables = flax_unet_variables(seed=7)
    _, vols = acdc_cases(0, n_volumes=1, volume_shape=(3, 40, 26), seed=3)
    _, more = acdc_cases(0, n_volumes=1, volume_shape=(5, 28, 44), seed=4)
    cases = vols + more
    return (JaxEvaluator(model, PATCH, 4), variables,
            Slice2DEvaluator(port_unet(variables), PATCH, 4, device="cpu"),
            cases)


def test_labels_and_metrics_equal_jax(pair):
    jax_ev, variables, ev, cases = pair
    preds = list(ev.predict_volumes(img for img, _ in cases))
    for (image, label), pred in zip(cases, preds):
        want = np.asarray(jax_ev.predict_volume(variables, image))
        assert pred.shape == image.shape == want.shape
        np.testing.assert_array_equal(pred, want)
        assert len(np.unique(pred)) > 1
        np.testing.assert_allclose(ev.metrics_for(pred, label),
                                   jax_ev.metrics_for(want, label),
                                   rtol=1e-12)
        got_m, got_pred = ev.test_volume(image, label)
        np.testing.assert_array_equal(got_pred, pred)


def test_validate_volumes_equal_jax_and_reuse_the_cache(pair):
    jax_ev, variables, ev, cases = pair
    want = jax_ev.validate_volumes(variables, cases)
    first = ev.validate_volumes(cases, cache=True)
    assert set(ev._prep_cache) == {("val", 0), ("val", 1)}
    cached = {k: v for k, v in ev._prep_cache.items()}
    again = ev.validate_volumes(cases, cache=True)
    assert all(ev._prep_cache[k] is v for k, v in cached.items())
    np.testing.assert_allclose(first, want, rtol=1e-12)
    np.testing.assert_allclose(again, want, rtol=1e-12)
    np.testing.assert_allclose(
        ev.validate_volume(*cases[1]), want[1], rtol=1e-12)


def test_the_evaluator_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA device"):
        Slice2DEvaluator(torch.nn.Identity(), PATCH, 4)
