"""The ACDC slice's model pieces against the JAX package: the 2-D U-Net in
eval mode and in train mode with 2-group BatchNorm, the element-wise
dropout, the align-corners upsample, and the weight conversion of the
``unet`` layout. n_filters 4 at 32x32, f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from bcp_tpu.convert.torch_ckpt import export_state_dict
from bcp_tpu.models.layers import upsample2x_align_corners as jax_upsample
from bcp_tpu_torch.convert import (load_reference_checkpoint,
                                   state_dict_from_flax)
from bcp_tpu_torch.models import UNet2D, create_model
from bcp_tpu_torch.models.layers import (ChannelDropout, Dropout, bn_groups,
                                         dropout_draws,
                                         upsample2x_align_corners)
from torch_port_helpers import flax_unet_variables, port_unet, unet_chns


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_unet_eval_matches_flax_f32(seed):
    """Logits and x_last to atol 1e-4 (f32 sums in another order)."""
    model, variables = flax_unet_variables(seed=seed)
    x = np.random.default_rng(seed).normal(size=(3, 32, 32, 1)).astype(
        np.float32)
    want, want_last = model.apply(variables, jnp.asarray(x), train=False)
    got, got_last = port_unet(variables)(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (3, 4, 32, 32)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(_nhwc(got_last), np.asarray(want_last),
                               atol=1e-4)


def test_unet_train_grouped_bn_matches_flax_f32():
    """Train mode, 2-group BatchNorm, dropout rate 0 on both sides: logits
    to atol 1e-4 and every BN running statistic to 1e-5."""
    model, variables = flax_unet_variables(seed=2, bn_groups=2)
    x = np.random.default_rng(2).normal(size=(4, 32, 32, 1)).astype(
        np.float32)
    want, upd = model.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
    port = port_unet(variables).train()
    with bn_groups(port, 2):
        got = port(_nchw(x))[0]
    np.testing.assert_allclose(_nhwc(got), np.asarray(want[0]), atol=1e-4)
    new = state_dict_from_flax({"params": variables["params"],
                                "batch_stats": jax.tree_util.tree_map(
                                    np.asarray, upd["batch_stats"])}, "unet")
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), new[k].numpy(), atol=1e-5,
                                       err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(v) == 2, k


def test_element_wise_dropout_is_flaxs_formula():
    """flax ``nn.Dropout(p)``: ``where(keep, x / (1 - p), 0)`` per element.
    The port, handed flax's own keep mask (read off its output: x has no
    zeros), gives flax's output bit for bit."""
    x = np.random.default_rng(3).normal(size=(2, 6, 5, 3)).astype(np.float32)
    want = np.asarray(nn.Dropout(0.3).apply(
        {}, jnp.asarray(x), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(7)}))
    keep = want != 0
    assert 0 < keep.mean() < 1
    d = Dropout(0.3).train()
    d.keep = _nchw(keep)
    got = d(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), want)
    np.testing.assert_array_equal(
        _nhwc(got), np.where(keep, x / np.float32(0.7), 0))
    assert torch.equal(d.eval()(_nchw(x)), _nchw(x))


def test_dropout_draws_hand_each_dropout_its_mask():
    """The U-Net's five encoder dropouts, in forward order, take keep masks
    of their inputs' shapes; a channel dropout keeps its (N, C) mask."""
    net = UNet2D(feature_chns=unet_chns(4)).train()
    drops = [m for m in net.modules() if isinstance(m, Dropout)]
    assert [m.p for m in drops] == [0.05, 0.1, 0.2, 0.3, 0.5]
    shapes = [(2, 4 * 2 ** i, 32 >> i, 32 >> i) for i in range(5)]
    keep = [torch.zeros(s, dtype=torch.bool) for s in shapes]
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(
        bool((o == 0).all()))) for m in drops]
    with dropout_draws(net, keep=keep):
        net(torch.randn(2, 1, 32, 32))
    for h in hooks:
        h.remove()
    assert seen == [True] * 5 and all(m.keep is None for m in drops)
    with pytest.raises(ValueError, match="4 keep masks for 5 dropouts"):
        with dropout_draws(net, keep=keep[:4]):
            pass
    assert isinstance(ChannelDropout(), Dropout)
    assert ChannelDropout().mask_shape(torch.zeros(2, 3, 4, 4, 4)) == (2, 3)


@pytest.mark.parametrize("shape", [(2, 2, 2, 3), (1, 4, 4, 4),
                                   (1, 5, 7, 4), (2, 16, 12, 2),
                                   (1, 128, 128, 2)])
def test_upsample_matches_jax_f32(shape):
    """Both interpolate in f32 from sample positions o (n - 1) / (2n - 1)
    rounded differently, so they part by about eps_f32 * n pixels, times
    the input's slope: max|port - JAX| <= 4 eps_f32 n max|x| for the larger
    side n (measured 0.4-0.9 eps n max|x| for n = 2-128; under 1e-6 of
    max|x| only while n <= 4)."""
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(x)))
    got = _nhwc(upsample2x_align_corners(_nchw(x)))
    assert got.shape == want.shape
    eps = np.finfo(np.float32).eps
    assert np.abs(got - want).max() <= 4 * eps * max(shape[1:3]) \
        * np.abs(x).max()


def test_upsample_of_a_side_of_one_repeats_it():
    """A side of 1 (a 16-pixel input's bottleneck): torch's align-corners
    grid, the reference's ``nn.Upsample``, repeats the one row; the JAX
    package's ``scale_and_translate`` leaves the second row 0, so this
    case is pinned against torch's semantics, not the JAX package's."""
    x = np.random.default_rng(5).normal(size=(2, 1, 6, 2)).astype(
        np.float32)
    got = upsample2x_align_corners(_nchw(x))
    assert got.shape == (2, 2, 2, 12)
    assert torch.equal(got[:, :, 0], got[:, :, 1])
    np.testing.assert_allclose(_nhwc(got)[:, 0], np.asarray(jax_upsample(
        jnp.asarray(x)))[:, 0], atol=1e-6)


def test_unet_weights_equal_export_state_dict():
    """``state_dict_from_flax(..., "unet")`` bit for bit against the JAX
    package's ``export_state_dict``, and strict into the port's model."""
    _, variables = flax_unet_variables(seed=5)
    got = state_dict_from_flax(variables, "unet")
    want = export_state_dict(variables, "unet")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    create_model("unet", 4, device="cpu", n_filters=4).load_state_dict(
        got, strict=True)


def test_reference_layouts_load_by_name(tmp_path):
    """A reference ``UNet_2d`` file: ``{'net', 'opt'}`` (``save_net_opt``)
    with the dead heads and a DataParallel prefix loads strictly."""
    _, variables = flax_unet_variables(seed=6)
    sd = state_dict_from_flax(variables, "unet")
    blob = {"net": {**{f"module.{k}": v for k, v in sd.items()},
                    "projection_head.0.weight": torch.zeros(2)},
            "opt": {"state": {}, "param_groups": []}}
    torch.save(blob, tmp_path / "unet_best_model.pth")
    model = create_model("unet", 4, device="cpu", n_filters=4)
    model.load_state_dict(load_reference_checkpoint(
        str(tmp_path / "unet_best_model.pth")), strict=True)


def test_factory_ladder_and_refusals():
    net = create_model("unet", 4, mode="train", device="cpu", n_filters=8)
    assert net.training
    assert net.encoder.down4.maxpool_conv[1].conv_conv[0].out_channels == 128
    assert create_model("unet", 4, device="cpu").decoder.out_conv \
        .in_channels == 16
    with pytest.raises(ValueError, match="V-Net"):
        create_model("unet", 4, device="cpu", fused_bwd=True)


def test_bf16_forward_keeps_f32_logits():
    net = create_model("unet", 4, device="cpu", n_filters=4,
                       compute_dtype=torch.bfloat16)
    logits, last = net(torch.randn(2, 1, 32, 32))
    assert logits.dtype == torch.float32 and last.dtype == torch.bfloat16
