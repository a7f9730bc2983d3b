"""The port's VNet3D against the flax VNet3D, weights moved by
``state_dict_from_flax``; the converter against ``export_state_dict``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bcp_tpu.convert.torch_ckpt import export_state_dict
from bcp_tpu_torch.convert import (load_reference_checkpoint,
                                   state_dict_from_flax)
from bcp_tpu_torch.models import VNet3D, create_model
from bcp_tpu_torch.models.layers import ChannelDropout
from torch_port_helpers import flax_vnet_variables, port_vnet


@pytest.mark.parametrize("batch,seed", [(1, 0), (2, 3)])
def test_vnet_matches_flax_eval_f32(batch, seed):
    model, variables = flax_vnet_variables(seed=seed)
    x = np.random.default_rng(seed).normal(
        size=(batch, 16, 16, 16, 1)).astype(np.float32)
    want_logits, want_feat = model.apply(variables, jnp.asarray(x),
                                         train=False)
    net = port_vnet(variables)
    with torch.no_grad():
        logits, feat = net(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(feat.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want_feat), rtol=1e-4, atol=1e-4)


def test_state_dict_from_flax_equals_export():
    _, variables = flax_vnet_variables()
    got = state_dict_from_flax(variables)
    want = export_state_dict(variables, "VNet", strict=False)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_state_dict_loads_strict_and_names_match_reference():
    _, variables = flax_vnet_variables()
    net = VNet3D(n_classes=2, n_filters=4)
    missing = net.load_state_dict(state_dict_from_flax(variables),
                                  strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    keys = list(net.state_dict())
    assert keys[0] == "encoder.block_one.conv.0.weight"
    assert "decoder.block_five_up.conv.0.weight" in keys
    assert keys[-1] == "decoder.out_conv.bias"


@pytest.mark.parametrize("wrap", ["raw", "net", "state_dict", "module"])
def test_load_reference_checkpoint_unwraps(tmp_path, wrap):
    _, variables = flax_vnet_variables()
    sd = state_dict_from_flax(variables)
    blob = dict(sd)
    blob["projection_head.0.weight"] = torch.zeros(3)   # a dead head
    if wrap == "module":
        blob = {f"module.{k}": v for k, v in blob.items()}
    elif wrap != "raw":
        blob = {wrap: blob, "epoch": 3}
    p = tmp_path / "m.pth"
    torch.save(blob, p)
    got = load_reference_checkpoint(str(p))
    assert list(got) == list(sd)
    VNet3D(n_classes=2, n_filters=4).load_state_dict(got, strict=True)


def test_bf16_forward_promotes_logits():
    _, variables = flax_vnet_variables()
    net = port_vnet(variables, dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 1, 16, 16, 16)).astype(np.float32))
    with torch.no_grad():
        logits, feat = net(x)
    assert logits.dtype == torch.float32 and feat.dtype == torch.bfloat16
    assert torch.isfinite(logits).all()


def test_train_mode_and_missing_card_raise():
    """Train mode builds a training model with its two dropouts; a mode
    other than train or test raises, and so does a missing card."""
    net = create_model("VNet", 2, mode="train", device="cpu", n_filters=4)
    assert net.training
    assert isinstance(net.enc_dropout, ChannelDropout)
    assert isinstance(net.decoder.dropout, ChannelDropout)
    with pytest.raises(ValueError, match="mode"):
        create_model("VNet", 2, mode="eval", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model("VNet", 2, n_filters=4)
