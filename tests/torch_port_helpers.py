"""Shared fixtures of the bcp_tpu_torch parity tests: a flax V-Net, 2-D
U-Net or zoo net with random, non-trivial weights and BN statistics, handed
to the port as numpy arrays through ``state_dict_from_flax``."""

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


# ---------------------------------------------------------------------------
# the model zoo: small fixtures of each net type, flax and port

#: (factory kwargs, input shape NCDHW / NCHW) of each zoo fixture; the 3-D
#: U-Net at (16, 16, 32, 32, 32) so every conv past the first is one the
#: kernels take, and at (2, 4, 4, 8, 8) where ``F.conv3d`` takes them all
UNETR_KW = dict(img_shape=(16, 16, 16), embed_dim=32, num_heads=2,
                num_layers=4, d_ff=64, ext_layers=(1, 2, 3, 4),
                width_scale=0.125)
ZOO = {
    "unet_3D": (dict(feat_channels=(16, 16, 32, 32, 32)), (2, 1, 16, 16, 16)),
    "unet_3D_narrow": (dict(feat_channels=(2, 4, 4, 8, 8)),
                       (2, 1, 16, 16, 16)),
    "unet_3D_dtc": (dict(feat_channels=(2, 4, 4, 8, 8)), (1, 1, 16, 16, 16)),
    "unetr": (UNETR_KW, (2, 1, 16, 16, 16)),
    "unetr_dtc": (UNETR_KW, (1, 1, 16, 16, 16)),
    "git_VNet": (dict(n_filters=4), (1, 1, 16, 16, 16)),
    "unet_3D_trilinear": (dict(feat=(16, 16, 32, 32)), (1, 1, 16, 16, 16)),
    "sep_unet_2d": (dict(feature_chns=(8, 16, 32, 64, 128), feat_dim=8),
                    (2, 1, 112, 112)),
    "unet_2d_bcp": (dict(feature_chns=(8, 16, 32, 64, 128)), (2, 1, 32, 32)),
    "unet_tsne": (dict(feature_chns=(8, 16, 32, 64, 128), feat_dim=8),
                  (2, 1, 32, 32)),
    "net_D": (dict(b_size=2), (2, 256, 3, 3)),
}


def zoo_type(name):
    """The factory key of fixture ``name``."""
    return "unet_3D" if name == "unet_3D_narrow" else name


def zoo_classes(name):
    return 4 if name in ("sep_unet_2d", "unet_2d_bcp", "unet_tsne") else 2


def to_last(a):
    """NC* -> N*C (numpy or torch)."""
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
    return np.moveaxis(a, 1, -1)


def to_first(a):
    """N*C -> NC* as a torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, 1)))


def _randomised_tree(variables, seed):
    """numpy variables with random norm scales, biases and statistics and
    random position embeddings (zeros at init)."""
    rng = np.random.default_rng(seed)

    def walk(node, stats):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, stats)
            elif stats:
                out[k] = (rng.normal(0.0, 0.1, v.shape) if k == "mean" else
                          rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif k == "bias" and "scale" in node:
                out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            elif k == "position_embeddings":
                out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    out = {"params": walk(variables["params"], False)}
    if "batch_stats" in variables:
        out["batch_stats"] = walk(variables["batch_stats"], True)
    return out


def flax_zoo(name, seed=0):
    """(flax model, numpy variables with random norms and statistics, input
    of the fixture's shape, NC* numpy) of zoo fixture ``name``; the 2-D
    extras' heads are materialised too."""
    from bcp_tpu.models import create_model as flax_create
    kw, shape = ZOO[name]
    model = flax_create(zoo_type(name), zoo_classes(name), **kw)
    x = np.random.default_rng(seed + 100).normal(size=shape).astype(
        np.float32)
    rngs = {"params": jax.random.PRNGKey(seed),
            "dropout": jax.random.PRNGKey(seed + 1)}
    if hasattr(model, "init_heads"):
        def full(m, x, f):
            return m(x, train=False), m.init_heads(f, train=False)
        feats = jnp.zeros((2, kw["feature_chns"][0]))
        variables = jax.jit(lambda r, a, f: model.init(
            r, a, f, method=full))(rngs, jnp.asarray(to_last(x)), feats)
    else:
        variables = jax.jit(lambda r, a: model.init(r, a, train=False))(
            rngs, jnp.asarray(to_last(x)))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    return model, _randomised_tree(variables, seed), x


def port_zoo(name, variables, mode="test", dtype=np.float32, **extra):
    """The port's net of fixture ``name`` on the CPU, weights from
    ``variables`` (``strict=True``)."""
    from bcp_tpu_torch.convert import state_dict_from_flax
    from bcp_tpu_torch.models import create_model
    kw, _ = ZOO[name]
    net = create_model(zoo_type(name), zoo_classes(name), mode=mode,
                       device="cpu", **{**kw, **extra})
    net.load_state_dict(state_dict_from_flax(variables, zoo_type(name),
                                             dtype), strict=True)
    if dtype == np.float64:
        net.double()
    return net


def flax_train_apply(model, variables, x, key=3, method=None):
    """A train-mode flax forward with its BN updates and every dropout's
    keep mask, in call order, read off the dropout's output (an element
    whose input is zero has no visible draw; its output is zero either
    way). A dropout of rate 0 draws nothing (the port's is an identity).
    Eager, so that the masks are values."""
    from flax import linen as nn
    keeps = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout) \
                and context.method_name == "__call__" \
                and context.module.rate > 0 \
                and not kwargs.get("deterministic", False):
            keep = np.asarray(out) != 0
            if context.module.broadcast_dims:     # a channel dropout
                keep = keep.any(axis=tuple(context.module.broadcast_dims))
            keeps.append(keep)
        return out

    with nn.intercept_methods(interceptor):
        out, upd = model.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(key)})
    return out, upd, keeps


def outputs(out):
    """A model's outputs as a tuple (a bare tensor as one element)."""
    return out if isinstance(out, tuple) else (out,)


def zoo_hold(got, want, tol=1e-4):
    """Every output of a port net (NC*) equal to the flax net's (N*C) to
    rtol = atol = ``tol``."""
    got, want = outputs(got), outputs(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype in (torch.float32, torch.bfloat16)
        w = np.asarray(w)
        g = to_last(g) if g.dim() > 2 else g.detach().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
