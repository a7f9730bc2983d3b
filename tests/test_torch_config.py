"""The port's Config presets are field-for-field the JAX package's, plus
the port's one field of its own: ``fused_bwd`` (an environment variable in
the JAX package), off by default."""

import dataclasses

import pytest

from bcp_tpu import config as jax_config
from bcp_tpu_torch import config as port_config


@pytest.mark.parametrize("preset", ["LA", "ACDC", "pancreas"])
def test_presets_equal(preset):
    port = port_config.PRESETS[preset]()
    ref = jax_config.PRESETS[preset]()
    assert dataclasses.asdict(port) == {**dataclasses.asdict(ref),
                                        "fused_bwd": False}
    assert port.labeled_sub_bs == ref.labeled_sub_bs
    assert port.unlabeled_bs == ref.unlabeled_bs
    assert port.unlabeled_sub_bs == ref.unlabeled_sub_bs


def test_fields_and_defaults_equal():
    port = [(f.name, f.default) for f in
            dataclasses.fields(port_config.Config)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jax_config.Config)]
    assert ("fused_bwd", False) in port
    port.remove(("fused_bwd", False))
    assert port == ref
    assert port_config.la_config(labelnum=4, eval_batch=8) == \
        port_config.Config(**dataclasses.asdict(
            jax_config.la_config(labelnum=4, eval_batch=8)))
