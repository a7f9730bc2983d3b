"""The ACDC slice's training ops against the JAX package: the per-class
Dice and the 2-D mix loss, the per-class largest-CC NMS of the argmax
pseudo-labels, the 2-D copy-paste mask, and the full-state EMA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcp_tpu.ops import cc as jax_cc
from bcp_tpu.ops import ema as jax_ema
from bcp_tpu.ops import losses as jax_losses
from bcp_tpu.ops import masks as jax_masks
from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.ops import cc, losses, masks
from bcp_tpu_torch.ops.ema import ema_update
from test_torch_train_ops import jax_cuboid_starts

C = 4


def _case(seed, n=3, s=(12, 10)):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, *s, C)) * 2).astype(np.float32)
    a = rng.integers(0, C, (n, *s)).astype(np.int32)
    b = rng.integers(0, C, (n, *s)).astype(np.int32)
    m = (rng.random(s) > 0.4).astype(np.int32)
    return logits, a, b, np.broadcast_to(m, (n, *s)).copy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


LOSSES = {
    "dice_per_class": (
        lambda l, a, b, m: jax_losses.dice_loss_per_class(
            jax.nn.softmax(l, axis=-1), a, C),
        lambda l, a, b, m: losses.dice_loss_per_class(
            torch.softmax(l, dim=1), a, C)),
    "dice_per_class_masked": (
        lambda l, a, b, m: jax_losses.dice_loss_per_class(
            jax.nn.softmax(l, axis=-1), a, C, m),
        lambda l, a, b, m: losses.dice_loss_per_class(
            torch.softmax(l, dim=1), a, C, m)),
    "mix_slice": (
        lambda l, a, b, m: sum(jax_losses.mix_loss_slice(l, a, b, m, C)),
        lambda l, a, b, m: sum(losses.mix_loss_slice(l, a, b, m, C))),
    "mix_slice_unlab": (
        lambda l, a, b, m: sum(jax_losses.mix_loss_slice(
            l, a, b, m, C, u_weight=0.5, unlab=True)),
        lambda l, a, b, m: sum(losses.mix_loss_slice(
            l, a, b, m, C, u_weight=0.5, unlab=True))),
    "mix_slice_pretrain": (
        lambda l, a, b, m: jax_losses.mix_loss_slice(
            l, a, b, m, C, u_weight=1.0, unlab=True)[0],
        lambda l, a, b, m: losses.mix_loss_slice(
            l, a, b, m, C, u_weight=1.0, unlab=True)[0]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_acdc_loss_value_and_grad_match_jax(name):
    """f32 value to rtol 1e-6; d(loss)/d(logits) to rtol 1e-5, atol 1e-7
    (the LA losses' gradient limits: sums over the batch in another
    order)."""
    jfn, tfn = LOSSES[name]
    logits, a, b, m = _case(len(name))
    jv, jg = jax.value_and_grad(lambda l: jfn(l, jnp.asarray(a),
                                              jnp.asarray(b),
                                              jnp.asarray(m)))(
        jnp.asarray(logits))
    lt = _nchw(logits).requires_grad_()
    tv = tfn(lt, torch.from_numpy(a).long(), torch.from_numpy(b).long(),
             torch.from_numpy(m))
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jg), rtol=1e-5, atol=1e-7)


def _disc(shape, c, r):
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                             indexing="ij"))
    return ((g - np.array(c).reshape(2, 1, 1)) ** 2).sum(0) <= r * r


def _seg_maps():
    """Multi-class 2-D maps with several components a class: discs, a size
    tie, a diagonal chain that only 8-connectivity joins, noise, and a map
    with an empty class."""
    s = (24, 20)
    maps = np.zeros((4, *s), np.int32)
    maps[0][_disc(s, (6, 6), 4)] = 1
    maps[0][_disc(s, (18, 14), 3)] = 1
    maps[0][_disc(s, (5, 15), 2.5)] = 2
    maps[0][_disc(s, (17, 4), 3.5)] = 2
    maps[0][20:23, 17:19] = 3
    maps[1][2:5, 2:5] = 1
    maps[1][12:15, 10:13] = 1
    for i in range(7):
        maps[1][4 + i, 12 + i] = 3
    maps[1][18:20, 2:4] = 3
    maps[2] = np.random.default_rng(8).integers(0, C, s)
    maps[3][_disc(s, (12, 10), 6)] = 2
    return maps


@pytest.mark.parametrize("connectivity", [None, 1, 2])
def test_largest_cc_per_class_equals_jax(connectivity):
    seg = _seg_maps()
    want = np.asarray(jax_cc.largest_cc_per_class(jnp.asarray(seg), C,
                                                  connectivity))
    got = cc.largest_cc_per_class(torch.from_numpy(seg), C, connectivity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want[3])) == {0, 2}


@pytest.mark.parametrize("connectivity", [None, 1, 2])
def test_get_multiclass_mask_equals_jax(connectivity):
    rng = np.random.default_rng(9)
    seg = _seg_maps()
    logits = (np.eye(C, dtype=np.float32)[seg] * 2.0
              + rng.normal(0, 0.4, (*seg.shape, C)).astype(np.float32))
    for nms in (False, True):
        want = np.asarray(jax_cc.get_multiclass_mask(
            jnp.asarray(logits), C, nms=nms, connectivity=connectivity))
        got = cc.get_multiclass_mask(_nchw(logits), C, nms=nms,
                                     connectivity=connectivity)
        np.testing.assert_array_equal(got.numpy(), want)


def test_2d_connectivity_none_is_full():
    """``None`` is 8-connectivity on a 2-D mask: a diagonal chain is one
    component, which 4-connectivity splits."""
    m = np.eye(6, dtype=np.int32)[None]
    full = cc.connected_components(torch.from_numpy(m))
    assert len(torch.unique(full[full > 0])) == 1
    four = cc.connected_components(torch.from_numpy(m), 1)
    assert len(torch.unique(four[four > 0])) == 6


@pytest.mark.parametrize("spatial,seed", [((256, 256), 0), ((32, 32), 1),
                                          ((9, 7), 2)])
def test_2d_ratio_mask_matches_jax_at_its_draws(spatial, seed):
    """``generate_mask``'s one zero square of int(dim * 2/3) per side (170
    at 256), from the same draws."""
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_masks.cuboid_mask(key, spatial))
    got = masks.cuboid_mask(spatial, jax_cuboid_starts(key, spatial))
    np.testing.assert_array_equal(got.numpy(), want)
    if spatial == (256, 256):
        assert masks.cuboid_sizes(spatial) == (170, 170)
        assert (got == 0).sum() == 170 * 170


def test_full_state_ema_matches_jax():
    """``ema_full_state``: parameters and BN running statistics move by
    the EMA (`ema_update_full`), to 1e-7; num_batches_tracked stays."""
    rng = np.random.default_rng(10)
    teacher = create_model("unet", C, device="cpu", n_filters=2)
    student = create_model("unet", C, device="cpu", n_filters=2)
    with torch.no_grad():
        for mod in (teacher, student):
            for t in list(mod.parameters()) + [
                    b for b in mod.buffers() if b.is_floating_point()]:
                t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(
                    np.float32)))
        student.encoder.in_conv.conv_conv[1].num_batches_tracked.fill_(7)
    before = {k: v.numpy().copy() for k, v in teacher.state_dict().items()}
    after_s = {k: v.numpy() for k, v in student.state_dict().items()}
    floats = [k for k in before if not k.endswith("num_batches_tracked")]
    want = jax_ema.ema_update_full({k: before[k] for k in floats},
                                   {k: after_s[k] for k in floats}, 0.99)
    ema_update(teacher, student, 0.99, full_state=True)
    got = teacher.state_dict()
    for k in floats:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-7, atol=1e-7, err_msg=k)
    assert int(got["encoder.in_conv.conv_conv.1.num_batches_tracked"]) == 0
