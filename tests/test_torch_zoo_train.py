"""The port's model zoo in train mode against the JAX package's, from the
flax variables carried over by ``state_dict_from_flax``: outputs and
BatchNorm statistics given the flax forward's dropout draws, the 2-D
extras' contrastive heads, and one gradient test per 3-D family against
``jax.grad``."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcp_tpu_torch.convert import state_dict_from_flax
from bcp_tpu_torch.models.layers import dropout_draws
from torch_port_helpers import (ZOO, flax_train_apply, flax_zoo, outputs,
                                port_zoo, to_first, to_last, zoo_hold,
                                zoo_type)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["unet_3D", "unet_3D_dtc", "unetr",
                                  "unetr_dtc", "unet_3D_trilinear",
                                  "sep_unet_2d", "unet_tsne"])
def test_train_forward_and_bn_statistics_match_flax(name):
    """Train mode, each dropout handed the flax forward's keep mask: the
    outputs and every BatchNorm's running statistics after the forward."""
    model, variables, x = flax_zoo(name, seed=1)
    want, upd, keeps = flax_train_apply(model, variables, to_last(x))
    net = port_zoo(name, variables, mode="train")
    # channel masks are (N, C) in both; the element-wise masks of the 2-D
    # nets move to NCHW, UNETR's (tokens, attention) share one layout
    convs = name not in ("unetr", "unetr_dtc")
    masks = [to_first(k) if convs and k.ndim > 2 else torch.from_numpy(k)
             for k in keeps]
    with dropout_draws(net, keep=masks), torch.no_grad():
        got = net(torch.from_numpy(x))
    zoo_hold(got, want)
    if name == "unet_3D_trilinear":     # no BatchNorm, no dropout
        assert not keeps and "batch_stats" not in upd
        return
    after = state_dict_from_flax({"params": variables["params"],
                                  "batch_stats": upd["batch_stats"]},
                                 zoo_type(name))
    sd = net.state_dict()
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["sep_unet_2d", "unet_tsne"])
@pytest.mark.parametrize("train", [False, True])
def test_contrastive_heads_match_flax(name, train):
    """``init_heads`` on (N, feature_chns[0]) rows: projection, prediction
    and the 2 x 4 selectors; in train mode the heads' BN statistics too."""
    model, variables, _ = flax_zoo(name, seed=2)
    dim = ZOO[name][0]["feature_chns"][0]
    feats = np.random.default_rng(2).normal(size=(6, dim)).astype(np.float32)

    def heads(m, f):
        return m.init_heads(f, train=train)

    if train:
        want, upd = model.apply(variables, jnp.asarray(feats), method=heads,
                                mutable=["batch_stats"])
    else:
        want = model.apply(variables, jnp.asarray(feats), method=heads)
    net = port_zoo(name, variables, mode="train" if train else "test")
    with torch.no_grad():
        got = net.init_heads(torch.from_numpy(feats))
    flat = lambda t: [t[0], t[1], *t[2], *t[3]]     # noqa: E731
    for g, w in zip(flat(got), flat(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with torch.no_grad():
        proj = net.forward_projection_head(torch.from_numpy(feats))
        pred = net.forward_prediction_head(proj)
    if not train:
        np.testing.assert_allclose(proj.numpy(), np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(pred.numpy(), np.asarray(want[1]), **TOL)
    else:
        sd = net.state_dict()
        after = state_dict_from_flax({"params": variables["params"],
                                      "batch_stats": upd["batch_stats"]},
                                     name)
        k = "heads.selectors_3.bn.running_var"
        # the head stack ran twice in the port (init_heads, then the
        # projection and prediction heads): the selectors' once, as flax
        np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


#: the largest gradient of a bias in front of a train-mode BatchNorm, as a
#: share of its conv's weight gradient (chip_smoke's BIAS_NOISE): the norm
#: takes out its mean, so its gradient is 0 up to rounding on both sides
BIAS_NOISE = 1e-3


def _grads_hold(net, want_gx, want_g, variables, name, x_grad,
                cancelling=()):
    np.testing.assert_allclose(to_last(x_grad), np.asarray(want_gx),
                               rtol=1e-4,
                               atol=1e-4 * float(np.abs(want_gx).max()))
    want = state_dict_from_flax({"params": want_g,
                                 "batch_stats": variables.get(
                                     "batch_stats", {})}, zoo_type(name))
    params = dict(net.named_parameters())
    assert set(params) <= set(want)
    for k, p in params.items():
        w = want[k].numpy()
        if k.endswith(cancelling):
            scale = float(params[k[:-4] + "weight"].grad.abs().max())
            assert max(float(p.grad.abs().max()),
                       float(np.abs(w).max())) <= BIAS_NOISE * scale, k
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()) + 1e-8,
                                   err_msg=k)


@pytest.mark.parametrize("name,train", [("unet_3D", True),
                                        ("unetr_dtc", False),
                                        ("git_VNet", False),
                                        ("unet_3D_trilinear", True)])
def test_gradients_match_jax_grad(name, train):
    """d(sum(out * r))/d(input, every parameter) for one net of each 3-D
    family: UNet3D in train mode (batch statistics, channel dropout from the
    flax draw) through the conv Function's plain backward, in f64 (its
    heads come out in f32 on both sides, whose backward casts r back: the
    gradients stay f64; in f32 the BatchNorms over the 2 x 1^3 bottom level
    make rounding of 1e-3), the others in f32: UNETR and git_VNet in
    eval mode, the trilinear net in train mode (its four maps). The biases
    in front of a train-mode BatchNorm have a gradient of 0 up to rounding:
    both sides must keep it below BIAS_NOISE of the conv's weight
    gradient."""
    if name == "unet_3D":
        with _x64():
            _grad_case(name, train, np.float64)
    else:
        _grad_case(name, train, np.float32)


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _grad_case(name, train, dt):
    model, variables, x = flax_zoo(name, seed=4)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, dt),
                                       variables)
    x = x.astype(dt)
    rng = np.random.default_rng(5)
    out0, _, keeps = (flax_train_apply(model, variables, to_last(x))
                      if train else (None, None, []))
    ref = outputs(out0 if train else model.apply(
        variables, jnp.asarray(to_last(x)), train=False))
    rs = [rng.normal(size=np.shape(o)).astype(np.float32) for o in ref]

    def loss(params, xl):
        v = {**variables, "params": params}
        if train:
            out, _ = model.apply(v, xl, train=True, mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(3)})
        else:
            out = model.apply(v, xl, train=False)
        return sum(jnp.sum(o.astype(jnp.float32) * r)
                   for o, r in zip(outputs(out), rs))

    want_g, want_gx = jax.grad(loss, argnums=(0, 1))(
        variables["params"], jnp.asarray(to_last(x)))
    net = port_zoo(name, variables, mode="train" if train else "test",
                   dtype=dt)
    xt = torch.from_numpy(x).requires_grad_(True)
    masks = [torch.from_numpy(k) for k in keeps]
    with dropout_draws(net, keep=masks if train else None):
        got = outputs(net(xt))
    sum((g.float() * to_first(r)).sum() for g, r in zip(got, rs)).backward()
    # UNet3D's conv biases feed train-mode BatchNorms
    cancelling = (".conv1.bias", ".conv2.bias") if name == "unet_3D" else ()
    _grads_hold(net, want_gx, want_g, variables, name, xt.grad, cancelling)


