"""Shared fixtures of the bcp_tpu_torch parity tests: a flax V-Net or 2-D
U-Net with random, non-trivial weights and BN statistics, handed to the
port as numpy arrays through ``state_dict_from_flax``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bcp_tpu.models import UNet2D as FlaxUNet2D
from bcp_tpu.models import VNet3D as FlaxVNet3D
from bcp_tpu_torch.convert import state_dict_from_flax
from bcp_tpu_torch.models import UNet2D, VNet3D

# One intra-op thread a process. pytest-xdist runs the suite in several
# worker processes, and torch's default of one OpenMP thread a core then
# puts workers x cores spinning threads on the cores: six workers on eight
# cores ran the port's files 4x slower than with one thread each. Every
# worker imports this module while it collects the test files.
torch.set_num_threads(1)


def flax_vnet_variables(n_filters=4, patch=(16, 16, 16), seed=0):
    """(flax model, numpy variables) with random BN scale/bias/stats."""
    model = FlaxVNet3D(n_classes=2, n_filters=n_filters,
                       normalization="batchnorm", has_dropout=False)
    x = jnp.zeros((1, *patch, 1), jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), x, train=False)
    return model, _randomised(variables, seed)


def _randomised(variables, seed):
    """numpy variables with random BN scale, bias, mean and var."""
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed)

    def randomise(path, leaf):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        if name == "bias" and len(path) >= 2 and (
                path[-2].key == "TorchBatchNorm_0"
                or path[-2].key in ("bn0", "bn1")):
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        return leaf

    variables = jax.tree_util.tree_map_with_path(randomise, variables)
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"]}


def unet_chns(n_filters):
    return tuple(n_filters * 2 ** i for i in range(5))


def flax_unet_variables(n_filters=4, patch=(32, 32), seed=0,
                        dropout=(0.0,) * 5, bn_groups=1):
    """(flax UNet2D, numpy variables) with random BN scale/bias/stats."""
    model = FlaxUNet2D(n_classes=4, feature_chns=unet_chns(n_filters),
                       dropout=dropout, bn_groups=bn_groups)
    x = jnp.zeros((1, *patch, 1), jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), x, train=False)
    return model, _randomised(variables, seed)


def port_unet(variables, n_filters=4, dtype=None, dropout=(0.0,) * 5):
    net = UNet2D(n_classes=4, feature_chns=unet_chns(n_filters),
                 dropout=dropout, dtype=dtype)
    net.load_state_dict(state_dict_from_flax(variables, "unet"), strict=True)
    return net.eval()


def port_vnet(variables, n_filters=4, dtype=None):
    net = VNet3D(n_classes=2, n_filters=n_filters, dtype=dtype)
    net.load_state_dict(state_dict_from_flax(variables), strict=True)
    return net.eval()
