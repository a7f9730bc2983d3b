"""The converter for every net type: ``state_dict_from_flax`` of the JAX
package's variables loads with ``strict=True`` into the port's module; the
git_VNet's reference layout through ``load_reference_checkpoint`` equals
``bcp_tpu.convert.export_state_dict`` bit for bit; the zoo nets with no
reference layout are refused as the JAX converter refuses them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bcp_tpu.convert.torch_ckpt import export_state_dict
from bcp_tpu.models import create_model as flax_create
from bcp_tpu_torch.convert import (load_checkpoint,
                                   load_reference_checkpoint,
                                   state_dict_from_flax)
from bcp_tpu_torch.models import MODEL_REGISTRY, create_model
from bcp_tpu_torch.models.factory import PORT_ONLY
from torch_port_helpers import ZOO, flax_zoo, zoo_classes, zoo_type

#: the three pipelines' nets, small
CLASSIC = {"VNet": (dict(n_filters=2), 2, (1, 16, 16, 16, 1)),
           "unet": (dict(n_filters=2), 4, (1, 32, 32, 1)),
           "VNet_pancreas": (dict(n_filters=2), 2, (1, 16, 16, 16, 1))}


@pytest.mark.parametrize("net_type",
                         sorted(set(MODEL_REGISTRY) - set(PORT_ONLY)))
def test_state_dict_from_flax_loads_strict(net_type):
    if net_type in CLASSIC:
        kw, classes, shape = CLASSIC[net_type]
        model = flax_create(net_type, classes, **kw)
        variables = jax.tree_util.tree_map(np.asarray, dict(model.init(
            jax.random.PRNGKey(0), jnp.zeros(shape), train=False)))
    else:
        _, variables, _ = flax_zoo(net_type)
        kw, classes = ZOO[net_type][0], zoo_classes(net_type)
    sd = state_dict_from_flax(variables, zoo_type(net_type))
    net = create_model(net_type, classes, device="cpu", **kw)
    res = net.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(variables))
    n_port = sum(t.numel() for k, t in net.state_dict().items()
                 if not k.endswith("num_batches_tracked"))
    assert n_flax == n_port


def test_git_vnet_reference_layout_is_the_jax_converters(tmp_path):
    model = flax_create("git_VNet", 2, n_filters=4)
    variables = jax.tree_util.tree_map(np.asarray, dict(model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 16, 1)), train=False)))
    want = export_state_dict(variables, "git_VNet", strict=True)
    path = tmp_path / "git.pth"
    torch.save({"net": {f"module.{k}": v for k, v in want.items()}}, path)
    got = load_reference_checkpoint(str(path), "git_VNet")
    mine = state_dict_from_flax(variables, "git_VNet")
    assert list(got) == list(want) == list(mine)
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(mine[k], want[k])
    net = create_model("git_VNet", 2, device="cpu", n_filters=4)
    net.load_state_dict(got, strict=True)
    assert list(net.state_dict())[:2] == ["block_one.conv.0.weight",
                                          "block_one.conv.0.bias"]
    assert "block_two.conv.2.weight" in net.state_dict()


@pytest.mark.parametrize("net_type", ["unet_3D", "unetr_dtc", "net_D",
                                      "sep_unet_2d", "unet_3D_trilinear"])
def test_zoo_without_reference_layout_is_refused(tmp_path, net_type):
    name = "unetr" if net_type == "unetr_dtc" else net_type
    kw = ZOO[name][0]
    net = create_model(net_type, zoo_classes(name), device="cpu", **kw)
    path = tmp_path / "own.pth"
    torch.save(net.state_dict(), path)
    with pytest.raises(KeyError, match="no torch mapping"):
        load_reference_checkpoint(str(path), net_type)
    # the port's own checkpoint loads
    net.load_state_dict(load_checkpoint(str(path), net_type), strict=True)
