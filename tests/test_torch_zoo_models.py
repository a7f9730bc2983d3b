"""The port's model zoo against the JAX package's, each from the flax
variables carried over by ``state_dict_from_flax``: eval-mode outputs (every
element of the tuple) in f32; the registry and the factory's defaults and
refusals. Train mode, the heads and the gradients are in
``test_torch_zoo_train.py``."""

import pytest
import torch

import jax.numpy as jnp

from bcp_tpu_torch.models import MODEL_REGISTRY, create_model
from torch_port_helpers import ZOO, flax_zoo, port_zoo, to_last, zoo_hold


@pytest.mark.parametrize("name", sorted(ZOO))
def test_eval_forward_matches_flax_f32(name):
    model, variables, x = flax_zoo(name)
    want = model.apply(variables, jnp.asarray(to_last(x)), train=False)
    net = port_zoo(name, variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    zoo_hold(got, want)


def test_registry_has_the_jax_packages_thirteen_keys():
    from bcp_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from bcp_tpu_torch.models.factory import PORT_ONLY
    ported = sorted(set(MODEL_REGISTRY) - set(PORT_ONLY))
    assert ported == sorted(JAX_REGISTRY)
    assert len(ported) == 13
    assert not set(PORT_ONLY) & set(JAX_REGISTRY)
    assert set(PORT_ONLY) <= set(MODEL_REGISTRY)


@pytest.mark.parametrize("net_type", ["unet_3D", "unetr", "sep_unet_2d",
                                      "net_D", "unet_3D_trilinear"])
def test_factory_refuses_v_net_options(net_type):
    with pytest.raises(ValueError, match="remat targets the V-Net"):
        create_model(net_type, 2, device="cpu", remat=True)
    with pytest.raises(ValueError, match="fused_bwd is the V-Net"):
        create_model(net_type, 2, device="cpu", fused_bwd=True)


def test_factory_defaults_follow_the_jax_factory():
    import bcp_tpu.models as jm
    for mode in ("train", "test"):
        git = create_model("git_VNet", 2, mode=mode, device="cpu",
                           n_filters=2)
        assert not any(isinstance(m, torch.nn.Dropout) or "Dropout" in
                       type(m).__name__ for m in git.modules())
        assert git.training == (mode == "train")
    assert jm.create_model("git_VNet", 2).normalization == "none"
    git = create_model("git_VNet", 2, device="cpu", n_filters=2,
                       has_dropout=True, remat=True, fused_bwd=True)
    assert type(git.enc_dropout).__name__ == "ChannelDropout"
    with pytest.raises(ValueError, match="normalization"):
        create_model("git_VNet", 2, device="cpu", normalization="batchnorm")
    assert create_model("unetr", 2, device="cpu", embed_dim=32, num_heads=2,
                        num_layers=4, d_ff=64, width_scale=0.125
                        ).img_shape == (128, 128, 128)
    assert create_model("unet_3D_dtc", 2, device="cpu",
                        feat_channels=(2, 4, 4, 8, 8)).n_heads == 2
    with pytest.raises(ValueError, match="compute_dtype"):
        create_model("net_D", 2, device="cpu", compute_dtype=torch.bfloat16)


def test_unetr_refuses_another_extent():
    net = create_model("unetr", 2, device="cpu", **ZOO["unetr"][0])
    with pytest.raises(ValueError, match="img_shape"):
        net(torch.zeros(1, 1, 16, 16, 32))


def test_bf16_zoo_forward_keeps_f32_heads():
    net = create_model("unet_3D_dtc", 2, device="cpu",
                       compute_dtype=torch.bfloat16,
                       feat_channels=(16, 16, 32, 32, 32))
    with torch.no_grad():
        tanh, seg = net(torch.randn(1, 1, 16, 16, 16))
    assert tanh.dtype == seg.dtype == torch.float32
    assert bool(torch.isfinite(seg).all()) and float(tanh.abs().max()) <= 1
