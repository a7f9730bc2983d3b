"""The port's extras against ``bcp_tpu.extras`` on seeded inputs: the
dead loss tail (channels-first in the port, the test moves axes), VAT in
2-D and 3-D with the JAX package's own random direction handed in, the
class selector with flax's BatchNorm, the feature memory and the
class-to-class contrastive loss."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcp_tpu import extras as jx
from bcp_tpu_torch import extras
from torch_port_helpers import (flax_unet_variables, flax_vnet_variables,
                                port_unet, port_vnet, to_first, to_last)


def _logits(seed, shape=(2, 4, 6, 5), c=3):
    """(N, C, *S) logits, (N, *S) labels and mask, numpy."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(shape[0], c, *shape[1:])).astype(np.float32)
    target = rng.integers(0, c, shape).astype(np.int64)
    mask = (rng.random(shape) > 0.4).astype(np.float32)
    return logits, target, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_onehot_cross_entropy_equals_jax(seed):
    logits, target, mask = _logits(seed)
    want = jx.masked_onehot_cross_entropy(
        jnp.asarray(to_last(logits)), jnp.asarray(target), jnp.asarray(mask))
    got = extras.masked_onehot_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(target),
        torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_dice_losses_equal_jax(c, masked):
    logits, target, mask = _logits(2, c=c)
    target = np.minimum(target, 1) if c == 1 else target
    m = mask if masked else None
    want = jx.dice_loss_weighted(jnp.asarray(to_last(logits)),
                                 jnp.asarray(target),
                                 None if m is None else jnp.asarray(m))
    got = extras.dice_loss_weighted(torch.from_numpy(logits),
                                    torch.from_numpy(target),
                                    None if m is None else
                                    torch.from_numpy(m))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    probs = torch.softmax(torch.from_numpy(logits), 1)
    want = jx.dice_loss_weighted_probs(jnp.asarray(to_last(probs)),
                                       jnp.asarray(target),
                                       None if m is None else jnp.asarray(m))
    got = extras.dice_loss_weighted_probs(probs, torch.from_numpy(target),
                                          None if m is None else
                                          torch.from_numpy(m))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_binary_and_soft_dice_equal_jax():
    rng = np.random.default_rng(3)
    p = rng.random((2, 3, 5, 4)).astype(np.float32)
    t = (rng.random((2, 3, 5, 4)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(extras.binary_dice_loss(torch.from_numpy(p),
                                      torch.from_numpy(t))),
        float(jx.binary_dice_loss(jnp.asarray(p), jnp.asarray(t))),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(extras.soft_dice_loss(torch.from_numpy(p),
                                    torch.from_numpy(t))),
        float(jx.soft_dice_loss(jnp.asarray(to_last(p)),
                                jnp.asarray(to_last(t)))), rtol=1e-6)


@pytest.mark.parametrize("dims", [2, 3])
def test_vat_equals_jax_with_the_same_direction(dims):
    """VAT2d through the 2-D U-Net, VAT3d through the V-Net, eval-mode
    forwards from the same weights; the port is handed the uniform draw the
    JAX function makes from its key. BatchNorm statistics stay as they
    were in a train-mode forward under the port's ``model``."""
    if dims == 2:
        model, variables = flax_unet_variables(n_filters=2, patch=(16, 16),
                                               seed=4)
        net = port_unet(variables, n_filters=2)
        shape, fn, jfn = (2, 16, 16, 1), extras.vat_loss_2d, jx.vat_loss_2d
    else:
        model, variables = flax_vnet_variables(n_filters=2, seed=4)
        net = port_vnet(variables, n_filters=2)
        shape, fn, jfn = (1, 16, 16, 16, 1), extras.vat_loss_3d, \
            jx.vat_loss_3d
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jfn(lambda v: model.apply(variables, v, train=False)[0],
               jnp.asarray(x), key)
    u = np.asarray(jax.random.uniform(key, shape))
    got = fn(lambda v: net(v)[0], to_first(x), to_first(u), model=net)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4,
                               atol=1e-6)
    # train-mode forwards inside VAT leave the running statistics alone
    before = {k: v.clone() for k, v in net.state_dict().items()}
    net.train()
    fn(lambda v: net(v)[0], to_first(x), to_first(u), model=net)
    after = net.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def _selector_pair(seed, dim_in=6, feat_dim=5):
    """A flax ClassSelector's variables (random BN statistics) and the
    port's selector with the same weights."""
    sel = jx.ClassSelector(feat_dim=feat_dim)
    v = jax.tree_util.tree_map(np.asarray, dict(sel.init(
        jax.random.PRNGKey(seed), jnp.zeros((3, dim_in)))))
    rng = np.random.default_rng(seed)
    v["batch_stats"]["BatchNorm_0"] = {
        "mean": rng.normal(size=feat_dim).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, feat_dim).astype(np.float32)}
    port = extras.ClassSelector(dim_in, feat_dim)
    p, s = v["params"], v["batch_stats"]["BatchNorm_0"]
    t = torch.from_numpy
    port.load_state_dict({
        "Dense_0.weight": t(p["Dense_0"]["kernel"].T.copy()),
        "Dense_0.bias": t(p["Dense_0"]["bias"]),
        "BatchNorm_0.weight": t(p["BatchNorm_0"]["scale"]),
        "BatchNorm_0.bias": t(p["BatchNorm_0"]["bias"]),
        "BatchNorm_0.running_mean": t(s["mean"]),
        "BatchNorm_0.running_var": t(s["var"]),
        "Dense_1.weight": t(p["Dense_1"]["kernel"].T.copy()),
        "Dense_1.bias": t(p["Dense_1"]["bias"])})
    return sel, v, port.eval()


@pytest.mark.parametrize("train", [False, True])
def test_class_selector_equals_flax(train):
    sel, v, port = _selector_pair(7)
    x = np.random.default_rng(8).normal(size=(9, 6)).astype(np.float32)
    port.train(train)
    got = port(torch.from_numpy(x))
    if train:
        want, upd = sel.apply(v, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        stats = upd["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(port.BatchNorm_0.running_var.numpy(),
                                   np.asarray(stats["var"]), rtol=1e-6)
        np.testing.assert_allclose(port.BatchNorm_0.running_mean.numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-6,
                                   atol=1e-7)
    else:
        want = sel.apply(v, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_feature_memory_and_contrastive_loss_equal_jax():
    pairs = [_selector_pair(10 + i) for i in range(4)]
    jsel = {c: (lambda f, s=s, v=v: s.apply(v, f)) for c, (s, v, _) in
            zip(range(2), pairs[:2])}
    jmem = {c: (lambda f, s=s, v=v: s.apply(v, f)) for c, (s, v, _) in
            zip(range(2), pairs[2:])}
    psel = {c: p for c, (_, _, p) in zip(range(2), pairs[:2])}
    pmem = {c: p for c, (_, _, p) in zip(range(2), pairs[2:])}
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(40, 6)).astype(np.float32)
    labels = rng.integers(0, 2, 40)
    want_mem = jx.FeatureMemory(elements_per_class=8, n_classes=2)
    want_mem.add_features(jsel, jnp.asarray(feats), labels)
    got_mem = extras.FeatureMemory(elements_per_class=8, n_classes=2)
    got_mem.add_features(psel, torch.from_numpy(feats), labels)
    for g, w in zip(got_mem.memory, want_mem.memory):
        np.testing.assert_array_equal(g, w)
    more = rng.normal(size=(30, 6)).astype(np.float32)
    more_l = rng.integers(0, 2, 30)
    want = jx.contrastive_class_to_class(jsel, jmem, jnp.asarray(more),
                                         jnp.asarray(more_l), 2,
                                         want_mem.memory)
    ft = torch.from_numpy(more).requires_grad_(True)
    got = extras.contrastive_class_to_class(psel, pmem, ft,
                                            torch.from_numpy(more_l), 2,
                                            got_mem.memory)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    got.backward()
    want_g = jax.grad(lambda f: jx.contrastive_class_to_class(
        jsel, jmem, f, jnp.asarray(more_l), 2, want_mem.memory))(
        jnp.asarray(more))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-7)
