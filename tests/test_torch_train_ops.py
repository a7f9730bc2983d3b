"""The port's training ops against the JAX package: copy-paste masks and
``mix``, the LA losses (values and gradients), the pseudo-label NMS, EMA,
ramps and the learning-rate schedule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcp_tpu.config import la_config as jax_la_config
from bcp_tpu.ops import cc as jax_cc
from bcp_tpu.ops import ema as jax_ema
from bcp_tpu.ops import losses as jax_losses
from bcp_tpu.ops import masks as jax_masks
from bcp_tpu.ops import ramps as jax_ramps
from bcp_tpu.train.state import lr_schedule
from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.ops import cc, losses, masks, ramps
from bcp_tpu_torch.ops.ema import ema_update
from bcp_tpu_torch.train.state import lr_at


def jax_cuboid_starts(key, spatial, ratio=2.0 / 3.0):
    """The start offsets ``masks.cuboid_mask`` draws from ``key``."""
    sizes = [int(s * ratio) for s in spatial]
    keys = jax.random.split(key, len(spatial))
    return tuple(int(jax.random.randint(k, (), 0, d - s))
                 for k, d, s in zip(keys, spatial, sizes))


@pytest.mark.parametrize("spatial,seed", [((112, 112, 80), 0),
                                          ((16, 16, 16), 1), ((9, 7, 5), 2)])
def test_cuboid_mask_matches_jax_at_its_draws(spatial, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_masks.cuboid_mask(key, spatial))
    got = masks.cuboid_mask(spatial, jax_cuboid_starts(key, spatial))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuboid_starts_range():
    rng = np.random.default_rng(0)
    sizes = masks.cuboid_sizes((112, 112, 80))
    assert sizes == (74, 74, 53)
    for _ in range(50):
        st = masks.cuboid_starts(rng, (112, 112, 80))
        assert all(0 <= s < d - z for s, d, z in zip(st, (112, 112, 80),
                                                     sizes))


def test_mix_images_and_labels():
    rng = np.random.default_rng(3)
    m = (rng.random((5, 4, 3)) > 0.5).astype(np.int32)
    a = rng.normal(size=(2, 5, 4, 3, 1)).astype(np.float32)
    b = rng.normal(size=(2, 5, 4, 3, 1)).astype(np.float32)
    la = rng.integers(0, 2, (2, 5, 4, 3)).astype(np.int32)
    lb = rng.integers(0, 2, (2, 5, 4, 3)).astype(np.int32)
    want = np.asarray(jax_masks.mix(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(m)))
    got = masks.mix(torch.from_numpy(a).permute(0, 4, 1, 2, 3),
                    torch.from_numpy(b).permute(0, 4, 1, 2, 3),
                    torch.from_numpy(m))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)
    want_l = np.asarray(jax_masks.mix(jnp.asarray(la), jnp.asarray(lb),
                                      jnp.asarray(m)))
    got_l = masks.mix(torch.from_numpy(la).long(), torch.from_numpy(lb).long(),
                      torch.from_numpy(m))
    np.testing.assert_array_equal(got_l.numpy(), want_l)


def _loss_case(seed, n=2, s=(6, 5, 4)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, *s, 2)).astype(np.float32) * 2
    a = rng.integers(0, 2, (n, *s)).astype(np.int32)
    b = rng.integers(0, 2, (n, *s)).astype(np.int32)
    m = (rng.random(s) > 0.4).astype(np.int32)
    return logits, a, b, np.broadcast_to(m, (n, *s)).copy()


LOSSES = {
    "dice": (lambda l, a, b, m: jax_losses.masked_dice_loss(l, a),
             lambda l, a, b, m: losses.masked_dice_loss(l, a)),
    "dice_masked": (lambda l, a, b, m: jax_losses.masked_dice_loss(l, a, m),
                    lambda l, a, b, m: losses.masked_dice_loss(l, a, m)),
    "ce_mean": (lambda l, a, b, m: jax_losses.cross_entropy_mean(l, a),
                lambda l, a, b, m: losses.cross_entropy_mean(l, a)),
    "ce_masked": (lambda l, a, b, m: jax_losses.masked_cross_entropy(l, a, m),
                  lambda l, a, b, m: losses.masked_cross_entropy(l, a, m)),
    "mix": (lambda l, a, b, m: jax_losses.mix_loss_volume(l, a, b, m),
            lambda l, a, b, m: losses.mix_loss_volume(l, a, b, m)),
    "mix_unlab": (lambda l, a, b, m: jax_losses.mix_loss_volume(
        l, a, b, m, u_weight=0.5, unlab=True),
        lambda l, a, b, m: losses.mix_loss_volume(l, a, b, m, u_weight=0.5,
                                                  unlab=True)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_grad_match_jax(name):
    """f32 value and d(loss)/d(logits) to rtol 1e-5, atol 1e-7."""
    jfn, tfn = LOSSES[name]
    logits, a, b, m = _loss_case(len(name))
    jv, jg = jax.value_and_grad(lambda l: jfn(l, jnp.asarray(a),
                                              jnp.asarray(b),
                                              jnp.asarray(m)))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).permute(0, 4, 1, 2, 3).requires_grad_()
    tv = tfn(lt, torch.from_numpy(a).long(), torch.from_numpy(b).long(),
             torch.from_numpy(m))
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lt.grad.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(jg), rtol=1e-5, atol=1e-7)


def test_softmax_probs_sigmoid_branch():
    x = np.random.default_rng(4).normal(size=(2, 3, 4, 1)).astype(np.float32)
    want = np.asarray(jax_losses.softmax_probs(jnp.asarray(x)))
    got = losses.softmax_probs(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-7)


def _ball(shape, c, r):
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                             indexing="ij"))
    return ((g - np.array(c).reshape(3, 1, 1, 1)) ** 2).sum(0) <= r * r


def _cc_masks():
    s = (20, 18, 16)
    one = _ball(s, (6, 6, 6), 4) | _ball(s, (14, 12, 10), 2.5)
    # two components of equal size (a size tie) and a diagonal chain that
    # only full connectivity joins
    tie = np.zeros(s, bool)
    tie[2:5, 2:5, 2:5] = True
    tie[12:15, 10:13, 8:11] = True
    diag = np.zeros(s, bool)
    for i in range(8):
        diag[3 + i, 3 + i, 3 + i] = True
    diag[14:16, 2:4, 12:14] = True
    rng = np.random.default_rng(5)
    noisy = rng.random(s) > 0.6
    empty = np.zeros(s, bool)
    return np.stack([one, tie, diag, noisy, empty]).astype(np.int32)


@pytest.mark.parametrize("connectivity", [None, 1, 2])
def test_largest_cc_equals_jax(connectivity):
    m = _cc_masks()
    want = np.asarray(jax_cc.largest_cc_batch(jnp.asarray(m), connectivity))
    got = cc.largest_cc_batch(torch.from_numpy(m), connectivity)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[4].sum() == 0


def test_size_tie_goes_to_the_lowest_label():
    m = _cc_masks()[1:2]
    got = cc.largest_cc_batch(torch.from_numpy(m)).numpy()[0]
    # both cubes have 27 voxels; the first cube holds the lower largest
    # flat index, so its label is the lower one
    assert got.sum() == 27 and got[2:5, 2:5, 2:5].all()


def test_get_cut_mask_with_nms_equals_jax():
    rng = np.random.default_rng(6)
    s = (16, 16, 12)
    blobs = np.stack([_ball(s, (5, 5, 5), 3) | _ball(s, (12, 12, 8), 2),
                      _ball(s, (8, 8, 6), 5)])
    logits = np.stack([np.where(blobs, 1.5, -1.5),
                       np.where(blobs, -1.5, 1.5)], axis=-1).astype(
        np.float32) * -1 + rng.normal(0, 0.3, (*blobs.shape, 2)).astype(
        np.float32)
    for nms in (False, True):
        want = np.asarray(jax_cc.get_cut_mask(jnp.asarray(logits), nms=nms))
        got = cc.get_cut_mask(torch.from_numpy(logits).permute(0, 4, 1, 2, 3),
                              nms=nms)
        np.testing.assert_array_equal(got.numpy(), want)


def test_ema_params_only_matches_jax():
    rng = np.random.default_rng(7)
    t_mod = torch.nn.BatchNorm1d(5)
    s_mod = torch.nn.BatchNorm1d(5)
    with torch.no_grad():
        for mod in (t_mod, s_mod):
            for p in mod.parameters():
                p.copy_(torch.from_numpy(rng.normal(size=5).astype(
                    np.float32)))
        s_mod.running_mean.fill_(3.0)
    tree_t = {"w": t_mod.weight.detach().numpy().copy(),
              "b": t_mod.bias.detach().numpy().copy()}
    tree_s = {"w": s_mod.weight.detach().numpy(),
              "b": s_mod.bias.detach().numpy()}
    want = jax_ema.ema_update(tree_t, tree_s, 0.99)
    ema_update(t_mod, s_mod, 0.99)
    np.testing.assert_allclose(t_mod.weight.detach().numpy(),
                               np.asarray(want["w"]), rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(t_mod.bias.detach().numpy(),
                               np.asarray(want["b"]), rtol=1e-7, atol=1e-7)
    assert torch.equal(t_mod.running_mean, torch.zeros(5))


@pytest.mark.parametrize("fn", ["sigmoid_rampup", "linear_rampup"])
def test_ramps_match_jax(fn):
    for cur in (0, 3, 20, 40, 55):
        np.testing.assert_allclose(
            getattr(ramps, fn)(cur, 40.0),
            float(getattr(jax_ramps, fn)(cur, 40.0)), rtol=1e-6)
    np.testing.assert_allclose(ramps.cosine_rampdown(3, 10),
                               float(jax_ramps.cosine_rampdown(3, 10)),
                               rtol=1e-6)


def test_lr_schedule_matches_jax():
    jcfg, cfg = jax_la_config(), la_config()
    sched = lr_schedule(jcfg, "self")
    for step in (0, 2499, 2500, 7600):
        np.testing.assert_allclose(lr_at(cfg, "self", step),
                                   float(sched(jnp.int32(step))), rtol=1e-6)
    assert lr_at(cfg, "pre", 9999) == lr_schedule(jcfg, "pre") == 0.01
