"""Weights into the port: reference ``.pth`` files and the JAX package's
flax variables.

The port's modules carry the reference state_dict names, so a reference
checkpoint needs no re-layout, only unwrapping
(:func:`load_reference_checkpoint`, as ``load_torch_checkpoint`` in
``bcp_tpu/convert/torch_ckpt.py:318-332``). Flax variables (numpy arrays)
go through :func:`state_dict_from_flax`, with the transposes of
``export_state_dict`` (`torch_ckpt.py:239-315`):

- conv kernel (*k, Ci, Co) -> weight (Co, Ci, *k);
- transposed-conv kernel (*k, Ci, Co) -> weight (Ci, Co, *k), spatially
  un-flipped (flax lowers it as an un-flipped fractionally-strided
  correlation, torch's is the conv adjoint);
- TorchBatchNorm scale/bias + batch_stats mean/var -> weight/bias +
  running_mean/running_var, and a zero ``num_batches_tracked``.

Mappings: the LA ``"VNet"``, the ACDC ``"unet"`` and the pancreas
``"VNet_pancreas"`` (flat names, no BN leaves: its instance norm holds no
state).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_BN_LEAVES = (
    ("weight", "params", "scale"),
    ("bias", "params", "bias"),
    ("running_mean", "batch_stats", "mean"),
    ("running_var", "batch_stats", "var"),
)

#: reference state_dict prefixes with no counterpart in the port: the dead
#: contrastive heads (`networks/VNet.py:250-278`, `networks/unet.py:214-236`)
DEAD_PREFIXES = ("projection_head", "prediction_head",
                 "contrastive_class_selector", "branchs")

#: the dead prefixes by net type: the pancreas V-Net's ``branchs`` holds its
#: block_nine and head (`torch_ckpt.py:132-145`), so only the contrastive
#: heads are dead there
_DEAD_BY_NET = {"VNet_pancreas": DEAD_PREFIXES[:3]}


def _vnet_mapping() -> List[Tuple[str, Tuple[str, ...], str]]:
    """(state_dict prefix, flax path, kind) of the LA V-Net
    (`torch_ckpt.py:58-102`, nested, batchnorm)."""
    out = []
    stages = [("encoder.", "block_one", 1), ("encoder.", "block_two", 2),
              ("encoder.", "block_three", 3), ("encoder.", "block_four", 3),
              ("encoder.", "block_five", 3), ("decoder.", "block_six", 3),
              ("decoder.", "block_seven", 3), ("decoder.", "block_eight", 2),
              ("decoder.", "block_nine", 1)]
    for pre, blk, n in stages:
        for i in range(n):
            out.append((f"{pre}{blk}.conv.{3 * i}", (blk, f"conv{i}"), "conv"))
            out.append((f"{pre}{blk}.conv.{3 * i + 1}",
                        (blk, f"norm{i}", "TorchBatchNorm_0"), "bn"))
    for blk in ("block_one_dw", "block_two_dw", "block_three_dw",
                "block_four_dw"):
        out.append((f"encoder.{blk}.conv.0", (blk, "conv"), "conv"))
        out.append((f"encoder.{blk}.conv.1",
                    (blk, "norm", "TorchBatchNorm_0"), "bn"))
    for blk in ("block_five_up", "block_six_up", "block_seven_up",
                "block_eight_up"):
        out.append((f"decoder.{blk}.conv.0", (blk, "deconv"), "deconv"))
        out.append((f"decoder.{blk}.conv.1",
                    (blk, "norm", "TorchBatchNorm_0"), "bn"))
    out.append(("decoder.out_conv", ("out_conv",), "conv"))
    return out


def _unet2d_mapping() -> List[Tuple[str, Tuple[str, ...], str]]:
    """(state_dict prefix, flax path, kind) of ``UNet_2d``
    (`torch_ckpt.py:105-131`): ``conv_conv`` indices 0 conv, 1 BN, 4 conv,
    5 BN."""
    out = []

    def conv_block(prefix: str, fpath: Tuple[str, ...]):
        for i, (ci, bi) in enumerate(((0, 1), (4, 5))):
            out.append((f"{prefix}.conv_conv.{ci}", fpath + (f"conv{i}",),
                        "conv"))
            out.append((f"{prefix}.conv_conv.{bi}", fpath + (f"bn{i}",),
                        "bn"))

    conv_block("encoder.in_conv", ("in_conv",))
    for k in range(1, 5):
        conv_block(f"encoder.down{k}.maxpool_conv.1", (f"down{k}",))
    for k in range(1, 5):
        out.append((f"decoder.up{k}.conv1x1", (f"up{k}", "conv1x1"), "conv"))
        conv_block(f"decoder.up{k}.conv", (f"up{k}", "conv"))
    out.append(("decoder.out_conv", ("out_conv",), "conv"))
    return out


def _vnet_pancreas_mapping() -> List[Tuple[str, Tuple[str, ...], str]]:
    """(state_dict prefix, flax path, kind) of the pancreas V-Net
    (`torch_ckpt.py:132-145`, flat, instance norm): the LA V-Net's convs
    without the ``encoder.`` / ``decoder.`` prefixes and without norms,
    block_nine's conv at ``branchs.0.0.conv.0`` and the head at
    ``branchs.0.1``, in the module's order."""
    out = []
    for blk, n, nxt, kind in (
            ("block_one", 1, "block_one_dw", "conv"),
            ("block_two", 2, "block_two_dw", "conv"),
            ("block_three", 3, "block_three_dw", "conv"),
            ("block_four", 3, "block_four_dw", "conv"),
            ("block_five", 3, "block_five_up", "deconv"),
            ("block_six", 3, "block_six_up", "deconv"),
            ("block_seven", 3, "block_seven_up", "deconv"),
            ("block_eight", 2, "block_eight_up", "deconv")):
        out += [(f"{blk}.conv.{3 * i}", (blk, f"conv{i}"), "conv")
                for i in range(n)]
        out.append((f"{nxt}.conv.0", (nxt, kind), kind))
    out.append(("branchs.0.0.conv.0", ("block_nine", "conv0"), "conv"))
    out.append(("branchs.0.1", ("out_conv",), "conv"))
    return out


_MAPPINGS = {"VNet": _vnet_mapping, "unet": _unet2d_mapping,
             "VNet_pancreas": _vnet_pancreas_mapping}


def _get(tree, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype))


def state_dict_from_flax(variables: Dict[str, dict], net_type: str = "VNet",
                         dtype=np.float32) -> "OrderedDict[str, torch.Tensor]":
    """The JAX package's ``{"params", "batch_stats"}`` -> the port's
    state_dict (loads with ``strict=True``), floats as ``dtype`` (f64 for
    the double-precision step tests)."""
    if net_type not in _MAPPINGS:
        raise KeyError(f"no mapping for net_type {net_type!r}; "
                       f"have {sorted(_MAPPINGS)}")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for prefix, fpath, kind in _MAPPINGS[net_type]():
        if kind == "bn":
            for suffix, col, leaf in _BN_LEAVES:
                src = params if col == "params" else stats
                out[f"{prefix}.{suffix}"] = _tensor(_get(src, fpath + (leaf,)),
                                                    dtype)
            out[f"{prefix}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
            continue
        w = np.asarray(_get(params, fpath + ("kernel",)), dtype)
        nsp = w.ndim - 2
        if kind == "conv":      # (*k, Ci, Co) -> (Co, Ci, *k)
            w = np.transpose(w, (nsp + 1, nsp) + tuple(range(nsp)))
        else:                   # un-flip, then (*k, Ci, Co) -> (Ci, Co, *k)
            w = np.transpose(np.flip(w, axis=tuple(range(nsp))),
                             (nsp, nsp + 1) + tuple(range(nsp)))
        out[f"{prefix}.weight"] = _tensor(w, dtype)
        out[f"{prefix}.bias"] = _tensor(_get(params, fpath + ("bias",)), dtype)
    return out


def load_reference_checkpoint(path: str, net_type: Optional[str] = None
                              ) -> "OrderedDict[str, torch.Tensor]":
    """A reference ``.pth`` as a state_dict for the port's ``net_type``
    module. Accepts a raw state_dict (LA, `LA_BCP_train.py:287`),
    ``{'net': ...}`` (pancreas, `pancreas_utils.py:160-166`) and
    ``{'state_dict': ...}``; strips a ``module.`` (DataParallel) prefix and
    drops the dead heads. ``branchs`` is dead in the LA V-Net and the U-Net
    (and when no ``net_type`` is given); ``VNet_pancreas`` keeps it, and a
    head at ``branchs.0.2`` (a branch built with a ``Dropout3d``,
    `torch_ckpt.py:141-144`) moves to the port's ``branchs.0.1``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("net", "state_dict"):
        if isinstance(blob, dict) and isinstance(blob.get(wrapper), dict):
            blob = blob[wrapper]
            break
    dead = _DEAD_BY_NET.get(net_type, DEAD_PREFIXES)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k, v in blob.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith(dead):
            continue
        if net_type == "VNet_pancreas" and k.startswith("branchs.0.2."):
            k = "branchs.0.1." + k[len("branchs.0.2."):]
        out[k] = v
    return out
