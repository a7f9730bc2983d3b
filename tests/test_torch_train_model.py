"""The port's train-mode model pieces against the JAX package: grouped
BatchNorm (output and running statistics), channel dropout given the same
keep mask, the train-mode V-Net forward, and a JAX TrainState's student and
teacher trees loading strictly into the train-mode port model."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from bcp_tpu.config import la_config as jax_la_config
from bcp_tpu.models import VNet3D as FlaxVNet3D
from bcp_tpu.models.layers import TorchBatchNorm as FlaxBN
from bcp_tpu.train.state import init_state as jax_init_state
from bcp_tpu_torch.convert import state_dict_from_flax
from bcp_tpu_torch.models import VNet3D, create_model
from bcp_tpu_torch.models.layers import (ChannelDropout, TorchBatchNorm,
                                         bn_groups, dropout_draws,
                                         frozen_running_stats)
from torch_port_helpers import flax_vnet_variables


def _bn_case(seed, n=4, c=8):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 5, 4, 3, c)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean = rng.normal(0, 0.1, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return x, scale, bias, mean, var


@pytest.mark.parametrize("groups", [1, 2])
def test_grouped_bn_train_matches_flax(groups):
    """Output to 1e-5 and running statistics to 1e-6 in f32 (sums in
    another order)."""
    x, scale, bias, mean, var = _bn_case(groups)
    bn = FlaxBN(groups=groups)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want, upd = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                         mutable=["batch_stats"])
    port = TorchBatchNorm(x.shape[-1], groups=groups).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean))
        port.running_var.copy_(torch.from_numpy(var))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    got = port(xt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-6)
    assert int(port.num_batches_tracked) == groups


def test_grouped_bn_bf16_normalises_in_bf16():
    x, scale, bias, mean, var = _bn_case(5)
    bn = FlaxBN(groups=2, dtype=jnp.bfloat16)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want, _ = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                       mutable=["batch_stats"])
    port = TorchBatchNorm(x.shape[-1], dtype=torch.bfloat16, groups=2).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.permute(0, 2, 3, 4, 1).float().detach().numpy()
                  - np.asarray(want, np.float32))
    # one bf16 rounding of mul/add and of the output: a few ulps of |y|<~8
    assert diff.max() <= 0.07


def test_frozen_running_stats_and_groups_context():
    x = torch.randn(4, 8, 3, 3, 3)
    bn = TorchBatchNorm(8).train()
    with frozen_running_stats(bn), bn_groups(bn, 2):
        assert bn.groups == 2
        bn(x)
    assert bn.groups == 1 and bn.update_running
    assert torch.equal(bn.running_mean, torch.zeros(8))
    assert int(bn.num_batches_tracked) == 0


def test_dropout_matches_flax_given_its_keep_mask():
    """flax ``nn.Dropout(0.5, broadcast_dims=spatial)``: the port, handed the
    channel maps flax kept, keeps the same maps and scales them by 2."""
    rng = np.random.default_rng(6)
    x = rng.uniform(0.5, 1.5, size=(3, 4, 5, 2, 16)).astype(np.float32)
    want = np.asarray(nn.Dropout(0.5, broadcast_dims=(1, 2, 3)).apply(
        {}, jnp.asarray(x), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(7)}))
    keep = torch.from_numpy(want[:, 0, 0, 0, :] != 0)      # (N, C)
    assert 0 < int(keep.sum()) < keep.numel()
    d = ChannelDropout().train()
    with dropout_draws(d, keep=[keep]):
        got = d(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert d.keep is None
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)
    assert torch.equal(d.eval()(torch.ones(1, 2, 1, 1, 1)),
                       torch.ones(1, 2, 1, 1, 1))


def test_dropout_generator_draws_are_reproducible():
    d = ChannelDropout().train()
    x = torch.ones(64, 32, 1, 1, 1)
    outs = []
    for _ in range(2):
        with dropout_draws(d, generator=torch.Generator().manual_seed(3)):
            outs.append(d(x))
    assert torch.equal(outs[0], outs[1])
    assert set(outs[0].unique().tolist()) == {0.0, 2.0}
    assert abs(outs[0].mean().item() - 1.0) < 0.1


@pytest.mark.parametrize("groups", [1, 2])
def test_train_mode_vnet_matches_flax(groups):
    """Train-mode V-Net (dropout off), n_filters 16 at a 16^3 patch so the
    20 convs run through ``Conv3x3x3Function``: logits to 1e-3 and every
    BN's running statistics to 1e-4 (f32, sums in other orders through 20
    normalised layers). Batch 8, so each group has 4 samples at the 1^3
    bottleneck, whose batch variance over 2 samples would amplify the f32
    rounding past these limits."""
    flax_model, variables = flax_vnet_variables(n_filters=16, seed=8)
    flax_model = flax_model.clone(bn_groups=groups)
    x = np.random.default_rng(9).normal(size=(8, 16, 16, 16, 1)).astype(
        np.float32)
    (want, _), upd = flax_model.apply(variables, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
    net = VNet3D(n_classes=2, n_filters=16)
    net.load_state_dict(state_dict_from_flax(variables), strict=True)
    net.train()
    with bn_groups(net, groups):
        got = net(torch.from_numpy(x).permute(0, 4, 1, 2, 3))[0]
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(want), rtol=1e-3, atol=1e-3)
    want_sd = state_dict_from_flax({"params": variables["params"],
                                    "batch_stats": upd["batch_stats"]})
    for k, v in net.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_jax_train_state_trees_load_strictly_into_train_model():
    cfg = jax_la_config(n_filters=4, patch_size=(16, 16, 16),
                        compute_dtype="float32")
    model = FlaxVNet3D(n_classes=2, n_filters=4, normalization="batchnorm",
                       has_dropout=True)
    tx = optax.sgd(0.01)
    st = jax_init_state(model, cfg, jax.random.PRNGKey(0), tx)
    port = create_model("VNet", 2, mode="train", device="cpu", n_filters=4)
    assert port.training and any(isinstance(m, ChannelDropout)
                                 for m in port.modules())
    for params, stats in ((st.params, st.batch_stats),
                          (st.teacher_params, st.teacher_batch_stats)):
        sd = state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, {"params": params, "batch_stats": stats}))
        port.load_state_dict(sd, strict=True)
    # and the train model's state_dict loads strictly into the eval model
    create_model("VNet", 2, device="cpu", n_filters=4).load_state_dict(
        port.state_dict(), strict=True)
