"""``tests/test_torch_zoo_steps.py``'s update tests for UNETR, UNETR_DTC
(the LA steps at their 16^3 window) and the 2-D ``unet_2d_bcp`` and
``unet_tsne`` (the ACDC steps at 32x32): one pre-train and one self-train
update each against the JAX package's jitted step in f64, with the same
tolerances."""

import pytest

from test_torch_zoo_steps import (_run, cases,  # noqa: F401
                                  test_losses_match,
                                  test_momentum_buffers_match,
                                  test_num_batches_tracked_counts_one_group,
                                  test_param_deltas_and_bn_stats_match,
                                  test_teacher_matches,
                                  test_teacher_pseudo_labels_match)


@pytest.fixture(scope="module", params=cases(("unetr", "unetr_dtc",
                                              "unet_2d_bcp", "unet_tsne")))
def stepped(request):
    name, stage = request.param.split("-")
    return name, stage, _run(name, stage)
