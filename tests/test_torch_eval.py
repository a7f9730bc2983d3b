"""The port's sliding-window evaluator and metrics against the JAX
package's (the evaluator on its XLA overlap-add loop, on the CPU)."""

import numpy as np
import pytest
import torch

from bcp_tpu.eval import metrics as jax_metrics
from bcp_tpu.eval.sliding_window import (
    SlidingWindowEvaluator as JaxEvaluator, pad_to_patch as jax_pad,
    window_starts as jax_starts)
from bcp_tpu_torch.eval import metrics
from bcp_tpu_torch.eval.sliding_window import (SlidingWindowEvaluator,
                                               pad_to_patch, window_starts)
from torch_port_helpers import flax_vnet_variables, port_vnet


@pytest.mark.parametrize("shape,patch,sxy,sz", [
    ((240, 200, 96), (112, 112, 80), 18, 4),
    ((23, 19, 21), (16, 16, 16), 6, 6),
    ((10, 30, 16), (16, 16, 16), 5, 3),
])
def test_window_grid_and_padding_identical(shape, patch, sxy, sz):
    got = window_starts(shape, patch, sxy, sz)
    want = jax_starts(shape, patch, sxy, sz)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    img = np.random.default_rng(0).random(shape).astype(np.float32)
    (a, oa), (b, ob) = pad_to_patch(img, patch), jax_pad(img, patch)
    assert oa == ob and a.tobytes() == b.tobytes()


def test_la_grid_has_270_windows():
    assert window_starts((240, 200, 96), (112, 112, 80), 18, 4).shape == \
        (270, 3)


@pytest.mark.parametrize("rule", ["threshold", "argmax"])
def test_evaluator_matches_jax_evaluator(rule):
    model, variables = flax_vnet_variables(seed=1)
    image = np.random.default_rng(1).normal(
        size=(23, 19, 21)).astype(np.float32)
    ref = JaxEvaluator(model, (16, 16, 16), 2, 6, 6, batch=4)
    want_label, want_score = ref.infer(variables, image, rule=rule)
    ev = SlidingWindowEvaluator(port_vnet(variables), (16, 16, 16), 2, 6, 6,
                                batch=4, device="cpu")
    label, score = ev.infer(image, rule=rule)
    assert score.shape == want_score.shape == (2, 23, 19, 21)
    np.testing.assert_allclose(score, want_score, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(label, want_label)


def test_padded_volume_and_case_api_match_jax():
    model, variables = flax_vnet_variables(seed=2)
    rng = np.random.default_rng(2)
    cases = [(rng.normal(size=s).astype(np.float32),
              (rng.random(s) > 0.6).astype(np.uint8))
             for s in ((12, 18, 20), (20, 17, 16))]
    ref = JaxEvaluator(model, (16, 16, 16), 2, 6, 6, batch=4)
    ev = SlidingWindowEvaluator(port_vnet(variables), (16, 16, 16), 2, 6, 6,
                                batch=4, device="cpu")
    for img, lab in cases:
        (m, pred), (wm, wpred) = (ev.evaluate_case(img, lab, nms=True),
                                  ref.evaluate_case(variables, img, lab,
                                                    nms=True))
        np.testing.assert_array_equal(pred, wpred)
        np.testing.assert_allclose(m, wm, rtol=1e-12)
    preds = list(ev.infer_cases(img for img, _ in cases))
    assert [p.shape for p in preds] == [img.shape for img, _ in cases]
    assert ev.validate_dice(cases) == pytest.approx(
        ref.validate_dice(variables, cases), abs=1e-12)


def test_evaluator_on_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlidingWindowEvaluator(None, (16, 16, 16), 2, 6, 6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal(seed):
    rng = np.random.default_rng(seed)
    a = rng.random((20, 18, 16)) > 0.55
    b = rng.random((20, 18, 16)) > 0.5
    assert metrics.calculate_metric_percase(a, b) == \
        jax_metrics.calculate_metric_percase(a, b)
    assert metrics.calculate_dice_hd95(a, b) == \
        jax_metrics.calculate_dice_hd95(a, b)
    for conn in (None, 1, 2):
        np.testing.assert_array_equal(
            metrics.host_largest_cc(a, conn),
            jax_metrics.host_largest_cc(a, conn))
