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
- dense kernel (in, out) -> ``Linear.weight`` (out, in);
- TorchBatchNorm scale/bias + batch_stats mean/var -> weight/bias +
  running_mean/running_var, and a zero ``num_batches_tracked``;
- LayerNorm scale/bias -> weight/bias; a bare parameter (UNETR's
  ``position_embeddings``) as it is.

Mappings: the LA ``"VNet"``, the ACDC ``"unet"``, the pancreas
``"VNet_pancreas"`` (flat names, no BN leaves: its instance norm holds no
state) and ``"git_VNet"`` (flat, no norm) have the reference's layouts,
which the JAX converter maps too (`torch_ckpt.py:148-153`). The other zoo
nets' modules are named after their flax paths (``conv_blk1.conv1``,
``layer3.attn.query``): their mapping walks the variables, and the 2-D
extras' ``body`` is the ``unet`` mapping under ``body.``. No reference
layout is known for those, so :func:`load_reference_checkpoint` refuses
them as the JAX converter does; the port's own checkpoints of any net type
load through :func:`load_checkpoint`.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Mapping
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


def _git_vnet_mapping() -> List[Tuple[str, Tuple[str, ...], str]]:
    """(state_dict prefix, flax path, kind) of ``git_VNet``
    (`torch_ckpt.py:62-102` with ``normalization="none"``): flat names,
    each block's Sequential stepping over [conv, relu]."""
    out = []
    for blk, n in (("block_one", 1), ("block_two", 2), ("block_three", 3),
                   ("block_four", 3), ("block_five", 3), ("block_six", 3),
                   ("block_seven", 3), ("block_eight", 2), ("block_nine", 1)):
        out += [(f"{blk}.conv.{2 * i}", (blk, f"conv{i}"), "conv")
                for i in range(n)]
    for blk in ("block_one_dw", "block_two_dw", "block_three_dw",
                "block_four_dw"):
        out.append((f"{blk}.conv.0", (blk, "conv"), "conv"))
    for blk in ("block_five_up", "block_six_up", "block_seven_up",
                "block_eight_up"):
        out.append((f"{blk}.conv.0", (blk, "deconv"), "deconv"))
    out.append(("out_conv", ("out_conv",), "conv"))
    return out


def _is_deconv(name: str) -> bool:
    """The zoo's transposed convs: UNet3D's and UNETR's ``deconv`` and
    UNETR's ``decoder*_upsampler``."""
    return name == "deconv" or name.endswith("_upsampler")


def _flax_paths(variables, root: Tuple[str, ...] = (),
                prefix: str = "") -> List[Tuple[str, Tuple[str, ...], str]]:
    """(state_dict prefix, flax path, kind) of every module under ``root``
    of a net whose port modules are named after the flax paths: a kernel
    is a dense layer (2-D), a transposed conv (:func:`_is_deconv`) or a
    conv; scale and bias are a BatchNorm where batch_stats hold its mean,
    else a LayerNorm; a bare array is a parameter."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = []

    def walk(node, path):
        name = prefix + ".".join(path[len(root):])
        if not isinstance(node, Mapping):
            out.append((name, path, "param"))
        elif "kernel" in node:
            kind = ("dense" if np.ndim(node["kernel"]) == 2 else
                    "deconv" if _is_deconv(path[-1]) else "conv")
            out.append((name, path, kind))
        elif "scale" in node:
            try:
                _get(stats, path)
                out.append((name, path, "bn"))
            except KeyError:
                out.append((name, path, "ln"))
        else:
            for key in node:
                walk(node[key], path + (key,))

    walk(_get(params, root), root)
    return out


def _unet2d_body_mapping(variables):
    """The 2-D extras: the ``unet`` mapping under ``body.``, and the
    contrastive heads (if any) by their flax paths under ``heads.``."""
    out = [(f"body.{p}", ("body",) + f, k) for p, f, k in _unet2d_mapping()]
    if "heads" in variables["params"]:
        out += _flax_paths(variables, ("heads",), "heads.")
    return out


_MAPPINGS = {"VNet": _vnet_mapping, "unet": _unet2d_mapping,
             "VNet_pancreas": _vnet_pancreas_mapping,
             "git_VNet": _git_vnet_mapping}
#: the net types whose mapping reads the variables
_TREE_MAPPINGS = {"unet_3D": _flax_paths, "unet_3D_dtc": _flax_paths,
                  "unetr": _flax_paths, "unetr_dtc": _flax_paths,
                  "net_D": _flax_paths, "unet_3D_trilinear": _flax_paths,
                  "sep_unet_2d": _unet2d_body_mapping,
                  "unet_2d_bcp": _unet2d_body_mapping,
                  "unet_tsne": _unet2d_body_mapping}


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
    if net_type in _MAPPINGS:
        mapping = _MAPPINGS[net_type]()
    elif net_type in _TREE_MAPPINGS:
        mapping = _TREE_MAPPINGS[net_type](variables)
    else:
        raise KeyError(f"no mapping for net_type {net_type!r}; have "
                       f"{sorted({**_MAPPINGS, **_TREE_MAPPINGS})}")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for prefix, fpath, kind in mapping:
        if kind == "param":
            out[prefix] = _tensor(_get(params, fpath), dtype)
            continue
        if kind == "ln":
            out[f"{prefix}.weight"] = _tensor(_get(params, fpath + ("scale",)),
                                              dtype)
            out[f"{prefix}.bias"] = _tensor(_get(params, fpath + ("bias",)),
                                            dtype)
            continue
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
        if kind == "dense":     # (in, out) -> (out, in)
            w = w.T
        elif kind == "conv":    # (*k, Ci, Co) -> (Co, Ci, *k)
            w = np.transpose(w, (nsp + 1, nsp) + tuple(range(nsp)))
        else:                   # un-flip, then (*k, Ci, Co) -> (Ci, Co, *k)
            w = np.transpose(np.flip(w, axis=tuple(range(nsp))),
                             (nsp, nsp + 1) + tuple(range(nsp)))
        out[f"{prefix}.weight"] = _tensor(w, dtype)
        node = _get(params, fpath)
        if "bias" in node:      # UNet3D's residual adapters have none
            out[f"{prefix}.bias"] = _tensor(node["bias"], dtype)
    return out


def load_checkpoint(path: str, net_type: Optional[str] = None
                    ) -> "OrderedDict[str, torch.Tensor]":
    """A ``.pth`` as a state_dict for the port's ``net_type`` module: the
    port's own checkpoints of any net type, and the reference's layouts.
    Accepts a raw state_dict (LA, `LA_BCP_train.py:287`), ``{'net': ...}``
    (pancreas, `pancreas_utils.py:160-166`) and ``{'state_dict': ...}``;
    strips a ``module.`` (DataParallel) prefix and drops the dead heads.
    ``branchs`` is dead in the LA V-Net and the U-Net (and when no
    ``net_type`` is given); ``VNet_pancreas`` keeps it, and a head at
    ``branchs.0.2`` (a branch built with a ``Dropout3d``,
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


def load_reference_checkpoint(path: str, net_type: Optional[str] = None
                              ) -> "OrderedDict[str, torch.Tensor]":
    """A reference ``.pth`` (:func:`load_checkpoint`) of a net type whose
    reference layout is known, the JAX converter's four
    (`torch_ckpt.py:148-153`); the other zoo nets raise its ``KeyError``."""
    if net_type is not None and net_type not in _MAPPINGS:
        raise KeyError(f"no torch mapping for net_type {net_type!r}; "
                       f"have {sorted(_MAPPINGS)}")
    return load_checkpoint(path, net_type)
