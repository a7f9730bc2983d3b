"""The layers the model zoo adds to the port, against the JAX package's:
flax's SAME 3^3 stride-2 transposed conv (odd and even extents, through the
converter's kernel flip), the trilinear resize, the gradient reversal,
dense layers and LayerNorm, flax's own BatchNorm."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from bcp_tpu.models.unet_extras import grad_reverse as jax_grad_reverse
from bcp_tpu.models.unet_extras import resize_trilinear as jax_resize
from bcp_tpu_torch.convert import state_dict_from_flax
from bcp_tpu_torch.models.layers import (ConvTransposeSame3d, FlaxBatchNorm,
                                         LayerNorm, Linear, grad_reverse,
                                         resize_trilinear)
from torch_port_helpers import to_first, to_last


def _flax_same_deconv(shape, seed=0):
    m = nn.ConvTranspose(5, (3, 3, 3), strides=(2, 2, 2), padding="SAME")
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    v = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return np.asarray(m.apply(v, jnp.asarray(x))), v, x


@pytest.mark.parametrize("shape", [(2, 4, 4, 4, 3), (1, 5, 6, 7, 3),
                                   (1, 3, 2, 5, 3)])
def test_same_transposed_conv_matches_flax(shape):
    """flax's SAME transpose pads the dilated input (2, 1); the port's layer
    (no padding, the first 2n planes) gives flax's output from the
    converter's un-flipped weight, at odd and even extents."""
    want, v, x = _flax_same_deconv(shape)
    deconv = ConvTransposeSame3d(3, 5)
    sd = state_dict_from_flax({"params": {"deconv": v["params"]}},
                              "unet_3D")
    deconv.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()})
    with torch.no_grad():
        got = deconv(to_first(x))
    assert got.shape[2:] == tuple(2 * n for n in shape[1:4])
    np.testing.assert_allclose(to_last(got), want, rtol=1e-5, atol=1e-5)
    # torch's padding=1, output_padding=1 keeps planes 1..2n: one off
    with torch.no_grad():
        shifted = F.conv_transpose3d(to_first(x), deconv.weight,
                                     deconv.bias, 2, 1, 1)
    assert np.abs(to_last(shifted) - want).max() > 1e-2


@pytest.mark.parametrize("shape,scale", [((2, 3, 4, 5, 2), (2, 2, 2)),
                                         ((1, 1, 2, 2, 3), (16, 32, 32)),
                                         ((1, 2, 3, 1, 2), (4, 8, 8)),
                                         ((1, 4, 2, 2, 2), (1, 2, 2))])
def test_resize_trilinear_matches_jax(shape, scale):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), scale))
    got = resize_trilinear(to_first(x), scale)
    np.testing.assert_allclose(to_last(got), want, rtol=1e-5, atol=1e-5)


def test_grad_reverse_matches_jax():
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3) - 2.0
    want = jax.grad(lambda v: jnp.sum(jax_grad_reverse(v, 2.5) ** 3))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = grad_reverse(xt, 2.5)
    assert torch.equal(y, xt)
    (y ** 3).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6)


def test_dense_and_layernorm_match_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    dense = nn.Dense(6)
    vd = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))
    lin = Linear(8, 6)
    lin.load_state_dict({
        "weight": torch.from_numpy(np.asarray(vd["params"]["kernel"]).T
                                   .copy()),
        "bias": torch.from_numpy(np.asarray(vd["params"]["bias"]))})
    np.testing.assert_allclose(
        lin(torch.from_numpy(x)).detach().numpy(),
        np.asarray(dense.apply(vd, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    ln = nn.LayerNorm(epsilon=1e-6)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    want = ln.apply({"params": {"scale": scale, "bias": bias}},
                    jnp.asarray(x))
    port = LayerNorm(8, 1e-6)
    port.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    bf = LayerNorm(8, 1e-6, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("train", [False, True])
def test_flax_batchnorm_matches_flax(train):
    """flax ``nn.BatchNorm``: biased batch variance, momentum 0.99 on the
    running averages, eps 1e-5 (not the reference's BatchNorm1d)."""
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, size=(7, 4)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=not train)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 4).astype(np.float32),
                    "bias": rng.normal(size=4).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=4).astype(np.float32),
                         "var": rng.uniform(0.5, 2, 4).astype(np.float32)}}
    if train:
        want, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    else:
        want = bn.apply(v, jnp.asarray(x))
    port = FlaxBatchNorm(4).train(train)
    port.load_state_dict({
        "weight": torch.from_numpy(v["params"]["scale"]),
        "bias": torch.from_numpy(v["params"]["bias"]),
        "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(v["batch_stats"]["var"])})
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    if train:
        for buf, leaf in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(port, buf).numpy(),
                np.asarray(upd["batch_stats"][leaf]), rtol=1e-6, atol=1e-6)
