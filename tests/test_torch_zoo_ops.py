"""The leaf functions the port had left out, against the JAX package's:
``sup_loss`` and ``softmax_mse`` (no gradient into the target),
``ema_update_two_students``, ``ThreeStreamBatchSampler`` and
``random_noise`` (the samplers and the noise bit for bit from one numpy
generator)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcp_tpu.data.sampler import ThreeStreamBatchSampler as JaxThree
from bcp_tpu.data.transforms import random_noise as jax_noise
from bcp_tpu.ops import ema as jax_ema
from bcp_tpu.ops import losses as jax_losses
from bcp_tpu_torch.data.sampler import ThreeStreamBatchSampler
from bcp_tpu_torch.data.transforms import random_noise
from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.ops import ema, losses
from torch_port_helpers import to_last


@pytest.mark.parametrize("shape", [(2, 2, 6, 5, 4), (3, 4, 8, 7)])
def test_sup_loss_equals_jax(shape):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=shape).astype(np.float32)
    target = rng.integers(0, shape[1], (shape[0], *shape[2:]))
    want = jax_losses.sup_loss(jnp.asarray(to_last(logits)),
                               jnp.asarray(target))
    got = losses.sup_loss(torch.from_numpy(logits), torch.from_numpy(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_softmax_mse_equals_jax_and_stops_the_target_gradient():
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
            for _ in range(2))
    want = jax_losses.softmax_mse(jnp.asarray(to_last(a)),
                                  jnp.asarray(to_last(b)))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got = losses.softmax_mse(ta, tb)
    np.testing.assert_allclose(to_last(got), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    got.sum().backward()
    assert tb.grad is None
    want_g = jax.grad(lambda x, y: jnp.sum(jax_losses.softmax_mse(x, y)),
                      argnums=(0, 1))(jnp.asarray(to_last(a)),
                                      jnp.asarray(to_last(b)))
    np.testing.assert_allclose(to_last(ta.grad), np.asarray(want_g[0]),
                               rtol=1e-5, atol=1e-7)
    assert not np.asarray(want_g[1]).any()


def test_ema_update_two_students_equals_jax():
    nets = [create_model("unet", 4, device="cpu", n_filters=2)
            for _ in range(3)]
    with torch.no_grad():
        for i, n in enumerate(nets):
            for p in n.parameters():
                p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                    .manual_seed(i * 100 + p.numel())))
    trees = [{k: v.detach().numpy().copy() for k, v in n.named_parameters()}
             for n in nets]
    want = jax_ema.ema_update_two_students(*trees, 0.99)
    ema.ema_update_two_students(*nets, 0.99)
    for k, p in nets[0].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("primary,bs,sbs", [(10, 6, 2), (9, 4, 2)])
def test_three_stream_sampler_equals_jax(primary, bs, sbs):
    args = (list(range(primary)), list(range(primary, primary + 7)), bs, sbs)
    got, want = ThreeStreamBatchSampler(*args, seed=3), JaxThree(*args,
                                                                 seed=3)
    assert len(got) == len(want)
    for _ in range(3):
        assert list(got.epoch()) == list(want.epoch())
    assert list(got) == list(want)
    with pytest.raises(ValueError):
        ThreeStreamBatchSampler([0, 1], [5], 4, 1)


def test_random_noise_equals_jax_bit_for_bit():
    image = np.random.default_rng(4).normal(size=(6, 5, 4)).astype(
        np.float32)
    got = random_noise(image, np.random.default_rng(5), sigma=0.2)
    want = jax_noise(image, np.random.default_rng(5), sigma=0.2)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
