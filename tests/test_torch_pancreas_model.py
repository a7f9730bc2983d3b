"""The port's pancreas V-Net (``VNet_pancreas``) against the flax
``VNet3D(normalization="instancenorm")``, weights moved by
``state_dict_from_flax``; the converter against ``export_state_dict``; the
net-type-aware ``load_reference_checkpoint``; the instance norm alone
against ``bcp_tpu.models.layers.instance_norm``.

Tolerances: logits and x8_up rtol = atol = 1e-4 in f32 (the two frameworks
sum the convs in another order); the instance norm 1e-6 in f32; state_dict
keys and values bit for bit. The patches are 32^3: at 16^3 the bottleneck
is 1^3 and the instance norm of one voxel is 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcp_tpu.convert.torch_ckpt import export_state_dict
from bcp_tpu.models import VNet3D as FlaxVNet3D
from bcp_tpu.models.layers import instance_norm as jax_instance_norm
from bcp_tpu_torch.convert import (load_reference_checkpoint,
                                   state_dict_from_flax)
from bcp_tpu_torch.models import VNet3D, VNetPancreas, create_model
from bcp_tpu_torch.models.layers import InstanceNorm

import jax

PATCH = (32, 32, 32)


def flax_pancreas(n_filters=4, seed=0):
    """(flax model, numpy variables) of the pancreas V-Net."""
    model = FlaxVNet3D(n_classes=2, n_filters=n_filters,
                       normalization="instancenorm", has_dropout=False)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, *PATCH, 1), jnp.float32),
                           train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    assert "batch_stats" not in variables
    return model, {"params": variables["params"]}


def port_pancreas(variables, n_filters=4):
    net = VNetPancreas(n_classes=2, n_filters=n_filters)
    net.load_state_dict(state_dict_from_flax(variables, "VNet_pancreas"),
                        strict=True)
    return net


def _forward(net, x):
    with torch.no_grad():
        logits, feat = net(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    return (logits.permute(0, 2, 3, 4, 1).numpy(),
            feat.permute(0, 2, 3, 4, 1).numpy())


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("batch,seed", [(1, 0), (2, 3)])
def test_pancreas_vnet_matches_flax_f32(train, batch, seed):
    model, variables = flax_pancreas(seed=seed)
    x = np.random.default_rng(seed).normal(
        size=(batch, *PATCH, 1)).astype(np.float32)
    want_logits, want_feat = model.apply(variables, jnp.asarray(x),
                                         train=train)
    net = port_pancreas(variables).train(train)
    logits, feat = _forward(net, x)
    np.testing.assert_allclose(logits, np.asarray(want_logits), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(feat, np.asarray(want_feat), rtol=1e-4,
                               atol=1e-4)


def test_factory_builds_the_pancreas_net_without_dropout():
    for mode in ("train", "test"):
        net = create_model("VNet_pancreas", 2, mode=mode, device="cpu",
                           n_filters=4)
        assert isinstance(net, VNetPancreas)
        assert net.training == (mode == "train")
        assert not any(isinstance(m, torch.nn.Dropout) for m in
                       net.modules())
        assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                       for m in net.modules())


def test_concatenated_batch_is_its_parts():
    """Instance norm is per sample: the self-train step's concatenated
    student forward equals the two separate forwards bit for bit."""
    _, variables = flax_pancreas()
    net = port_pancreas(variables).train()
    x = torch.randn(4, 1, *PATCH, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        whole = net(x)[0]
        parts = torch.cat([net(x[:2])[0], net(x[2:])[0]])
    np.testing.assert_allclose(whole.numpy(), parts.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("head", [1, 2])
def test_state_dict_from_flax_equals_export(head):
    """Keys and values bit for bit against ``export_state_dict`` with the
    port's state_dict as its template; at head 2 the template is the
    reference's layout for a branch built with a ``Dropout3d``."""
    _, variables = flax_pancreas()
    got = state_dict_from_flax(variables, "VNet_pancreas")
    template = dict(VNetPancreas(n_filters=4).state_dict())
    if head == 2:
        template = {k.replace("branchs.0.1.", "branchs.0.2."): v
                    for k, v in template.items()}
    want = export_state_dict(variables, "VNet_pancreas", template=template)
    if head == 2:
        want = {k.replace("branchs.0.2.", "branchs.0.1."): v
                for k, v in want.items()}
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_names_are_the_reference_flat_layout():
    keys = list(VNetPancreas(n_filters=4).state_dict())
    assert keys[0] == "block_one.conv.0.weight"
    assert "block_three.conv.6.weight" in keys     # [conv, norm, relu] x 3
    assert "block_eight_up.conv.0.bias" in keys
    assert keys[-4:] == ["branchs.0.0.conv.0.weight",
                         "branchs.0.0.conv.0.bias",
                         "branchs.0.1.weight", "branchs.0.1.bias"]
    assert not any(k.startswith(("encoder.", "decoder.")) for k in keys)


@pytest.mark.parametrize("head", [1, 2])
@pytest.mark.parametrize("wrap", ["raw", "net", "module"])
def test_reference_pth_loads_strictly_with_block_nine_and_head(
        tmp_path, head, wrap):
    """A reference-layout pancreas ``.pth`` (flat names, ``branchs.0.0`` and
    the head at ``branchs.0.1``, or ``branchs.0.2`` behind a dropout) loads
    strictly through the net-type-aware reader and gives the same logits;
    the dead contrastive heads are dropped."""
    _, variables = flax_pancreas(seed=2)
    src = port_pancreas(variables).eval()
    sd = dict(src.state_dict())
    sd["projection_head.0.weight"] = torch.zeros(3)
    if head == 2:
        sd = {k.replace("branchs.0.1.", "branchs.0.2."): v
              for k, v in sd.items()}
    if wrap == "module":
        sd = {f"module.{k}": v for k, v in sd.items()}
    blob = {"net": sd, "opt": {}} if wrap == "net" else sd
    path = tmp_path / "VNet_pancreas_best_model.pth"
    torch.save(blob, path)
    loaded = load_reference_checkpoint(str(path), "VNet_pancreas")
    assert "branchs.0.0.conv.0.weight" in loaded
    assert "branchs.0.1.weight" in loaded
    net = VNetPancreas(n_filters=4).eval()
    net.load_state_dict(loaded, strict=True)
    x = np.random.default_rng(4).normal(size=(1, *PATCH, 1)).astype(
        np.float32)
    np.testing.assert_array_equal(_forward(net, x)[0], _forward(src, x)[0])


def test_la_and_unet_readers_still_drop_branchs(tmp_path):
    """Without a net type, and for the LA V-Net and the U-Net, ``branchs``
    stays a dead prefix, as before the pancreas slice."""
    sd = dict(VNet3D(n_filters=4).state_dict())
    sd["branchs.0.0.conv.0.weight"] = torch.zeros(2)
    path = tmp_path / "VNet_best_model.pth"
    torch.save(sd, path)
    for net_type in (None, "VNet", "unet"):
        loaded = load_reference_checkpoint(str(path), net_type)
        assert not any(k.startswith("branchs") for k in loaded)
    VNet3D(n_filters=4).load_state_dict(
        load_reference_checkpoint(str(path), "VNet"), strict=True)


@pytest.mark.parametrize("shape,seed", [((2, 3, 8, 6, 4), 0),
                                        ((1, 5, 2, 2, 2), 1)])
def test_instance_norm_matches_jax(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    want = np.asarray(jax_instance_norm(jnp.asarray(np.moveaxis(x, 1, -1))))
    got = InstanceNorm()(torch.from_numpy(x))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want,
                               rtol=1e-6, atol=1e-6)
    # the same on a channels_last_3d input, whose layout it keeps
    cl = torch.from_numpy(x).contiguous(memory_format=torch.channels_last_3d)
    got_cl = InstanceNorm()(cl)
    assert got_cl.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_allclose(got_cl.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_instance_norm_computes_in_its_dtype_with_f32_statistics():
    x = torch.randn(2, 4, 6, 6, 6, generator=torch.Generator().manual_seed(0))
    y = InstanceNorm(dtype=torch.bfloat16)(x)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), InstanceNorm()(x).numpy(),
                               atol=3e-2)
    assert InstanceNorm()(x.double()).dtype == torch.float64
    assert not list(InstanceNorm().state_dict())
