"""The pancreas pieces of the port's ops against the JAX package's: the
fixed 64^3 copy-paste cube at the JAX draws' start offsets (exact), the
binary pseudo-label with largest-CC NMS at connectivity 2 (exact), and
Adam against ``optax.adam`` in f64 over three steps (1e-12 relative: the
two formulas are the same function up to the order of a few roundings)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bcp_tpu.ops import cc as jax_cc
from bcp_tpu.ops import masks as jax_masks
from bcp_tpu_torch.config import pancreas_config
from bcp_tpu_torch.ops import cc, masks
from bcp_tpu_torch.train.state import build_optimizer
from test_torch_train_ops import _ball


def jax_fixed_starts(key, spatial, patch):
    """The start offsets ``masks.cuboid_mask_fixed`` draws from ``key``."""
    keys = jax.random.split(key, len(spatial))
    return tuple(int(jax.random.randint(k, (), 0, d - patch))
                 for k, d in zip(keys, spatial))


@pytest.mark.parametrize("spatial,patch,seed", [((96, 96, 96), 64, 0),
                                                ((32, 32, 32), 16, 1),
                                                ((20, 18, 16), 8, 2)])
def test_fixed_mask_matches_jax_at_its_draws(spatial, patch, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_masks.cuboid_mask_fixed(key, spatial, patch))
    got = masks.cuboid_mask_fixed(spatial,
                                  jax_fixed_starts(key, spatial, patch),
                                  patch)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == 0).sum() == patch ** 3


def test_fixed_starts_stay_below_dim_minus_patch():
    """The upper bound is exclusive, as ``jax.random.randint`` and the
    reference's ``np.random.randint``: the cube never touches the far
    face."""
    rng = np.random.default_rng(0)
    starts = np.array([masks.fixed_starts(rng, (96, 96, 96), 64)
                       for _ in range(2000)])
    assert starts.min() == 0 and starts.max() == 96 - 64 - 1


def test_cut_mask_nms_at_connectivity_2_equals_jax():
    """The pancreas pseudo-label (`cc_connectivity` 2): class-1 prob >= 0.5,
    then the largest component under 18-connectivity, where a chain of
    edge neighbours joins and a chain of corner neighbours does not."""
    rng = np.random.default_rng(6)
    s = (16, 16, 12)
    edge = np.zeros(s, bool)
    for i in range(9):                 # edge-adjacent chain, 17 voxels
        edge[2 + i, 2 + i, 3] = True
        if i < 8:
            edge[3 + i, 2 + i, 3] = True
    corner = np.zeros(s, bool)
    for i in range(10):                # corner-adjacent chain, 10 voxels
        corner[2 + i, 2 + i, 2 + i] = True
    corner[12:15, 12:15, 9:11] = True  # 18 voxels, the largest at 2
    blobs = np.stack([_ball(s, (5, 5, 5), 3) | _ball(s, (12, 12, 8), 2),
                      edge | _ball(s, (12, 4, 9), 1.5), corner])
    logits = np.stack([np.where(blobs, -1.5, 1.5),
                       np.where(blobs, 1.5, -1.5)], axis=-1).astype(
        np.float32) + rng.normal(0, 0.3, (*blobs.shape, 2)).astype(
        np.float32)
    want = np.asarray(jax_cc.get_cut_mask(jnp.asarray(logits), nms=True,
                                          connectivity=2))
    got = cc.get_cut_mask(torch.from_numpy(logits).permute(0, 4, 1, 2, 3),
                          nms=True, connectivity=2)
    np.testing.assert_array_equal(got.numpy(), want)
    # connectivity matters on these masks
    full = cc.get_cut_mask(torch.from_numpy(logits).permute(0, 4, 1, 2, 3),
                           nms=True, connectivity=None)
    assert not torch.equal(full, got)


def test_adam_matches_optax_over_three_steps_f64():
    """``build_optimizer`` of the pancreas preset (Adam, lr 1e-3) against
    ``optax.adam(1e-3)`` on the same f64 gradients, three steps, with
    gradients whose magnitudes span 1e-9 to 10 (Adam's eps is 1e-8)."""
    cfg = pancreas_config()
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    start = [rng.normal(size=s) for s in shapes]
    grads = [[rng.normal(size=s) * 10.0 ** rng.integers(-9, 2, size=s)
              for s in shapes] for _ in range(3)]
    params = [torch.tensor(p, dtype=torch.float64, requires_grad=True)
              for p in start]
    opt = build_optimizer(cfg, params)
    assert isinstance(opt, torch.optim.Adam)
    tx = optax.adam(cfg.base_lr)
    jax.config.update("jax_enable_x64", True)
    try:
        jparams = [jnp.asarray(p, jnp.float64) for p in start]
        jstate = tx.init(jparams)
        for step in grads:
            for p, g in zip(params, step):
                p.grad = torch.tensor(g, dtype=torch.float64)
            opt.step()
            jg = [jnp.asarray(g, jnp.float64) for g in step]
            updates, jstate = tx.update(jg, jstate, jparams)
            jparams = optax.apply_updates(jparams, updates)
        want = [np.asarray(p) for p in jparams]
        count = int(jstate[0].count)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert all(w.dtype == np.float64 for w in want)
    for p, w, s in zip(params, want, start):
        got = p.detach().numpy()
        np.testing.assert_allclose(got - s, w - s, rtol=1e-12,
                                   atol=1e-12 * np.abs(w - s).max())
    assert count == 3
    assert all(int(opt.state[p]["step"]) == 3 for p in params)
