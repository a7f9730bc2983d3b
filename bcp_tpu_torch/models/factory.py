"""Model registry: ``bcp_tpu/models/factory.py`` for the port, the thirteen
net types of the JAX package's ``MODEL_REGISTRY`` (`factory.py:28-129`):
the LA ``"VNet"``, the ACDC ``"unet"``, the pancreas ``"VNet_pancreas"``
and the model zoo (``"git_VNet"``, ``"unet_3D"``, ``"unet_3D_dtc"``,
``"unetr"``, ``"unetr_dtc"``, ``"sep_unet_2d"``, ``"unet_2d_bcp"``,
``"unet_tsne"``, ``"net_D"``, ``"unet_3D_trilinear"``), with the JAX
factory's defaults; and a fourteenth that only the port has,
``"swin_unetr"`` (MONAI's SwinUNETR, ``models/swin_unetr.py``).

``fused_bwd`` (kernel D's backward of the V-Net's 3^3 convs) and
``remat`` (the V-Net's rematerialised blocks) are taken by the three
V-Nets only, the JAX trainer's rule (`trainer.py:178-182`); the other net
types refuse them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from bcp_tpu_torch.device import resolve_device
from bcp_tpu_torch.models.swin_unetr import SwinUNETR
from bcp_tpu_torch.models.unet2d import UNet2D
from bcp_tpu_torch.models.unet3d import UNet3D
from bcp_tpu_torch.models.unet_extras import (NetD, SepUNet2D, UNet2DBCP,
                                              UNet3DTrilinear, UNetTsne)
from bcp_tpu_torch.models.unetr import UNETR
from bcp_tpu_torch.models.vnet3d import GitVNet, VNet3D, VNetPancreas

#: the net types whose blocks take ``fused_bwd`` and ``remat``
VNETS = ("VNet", "VNet_pancreas", "git_VNet")
#: the net types only the port has (no flax module to convert from)
PORT_ONLY = ("swin_unetr",)


def _unet(class_num: int, mode: str, n_filters=None, **kw):
    """`net_factory('unet')` (`factory.py:27-33`): ``UNet_2d`` with its
    dropout in train mode; ``n_filters`` scales the whole channel ladder
    (reference: 16)."""
    if n_filters:
        kw["feature_chns"] = tuple(n_filters * 2 ** i for i in range(5))
    return UNet2D(n_classes=class_num, **kw)


def _git_vnet(class_num: int, mode: str, normalization: str = "none",
              has_dropout: bool = False, **kw):
    """`git_VNet.VNet` (`factory.py:82-91`): no norm, dropout only when
    asked, in either mode."""
    if normalization != "none":
        raise ValueError(f"git_VNet's normalization is 'none' in the port, "
                         f"got {normalization!r}")
    return GitVNet(n_classes=class_num, has_dropout=has_dropout, **kw)


def _net_d(class_num: int, mode: str, b_size: int = 4, dtype=None):
    """`net_D` (`factory.py:116-121`): ``class_num`` is ignored (one
    sigmoid output); the JAX module has no compute dtype."""
    if dtype is not None:
        raise ValueError("net_D computes in f32: it takes no compute_dtype")
    return NetD(b_size=b_size)


MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {
    # `net_factory('VNet')` (`net_factory.py:8-11`): batchnorm; dropout on
    # for training, off for test-mode construction (`factory.py:38-43`)
    "VNet": lambda class_num, mode, **kw: VNet3D(
        n_classes=class_num, has_dropout=(mode == "train"), **kw),
    "unet": _unet,
    # `pancreas/Vnet.py:92-194` + `create_Vnet` (`factory.py:46-51`):
    # instance norm, no dropout in either mode
    "VNet_pancreas": lambda class_num, mode, **kw: VNetPancreas(
        n_classes=class_num, **kw),
    # the residual 3-D U-Net and its dual-task form (`factory.py:54-64`);
    # their channel dropout acts in train mode whatever the mode
    "unet_3D": lambda class_num, mode, **kw: UNet3D(
        n_classes=class_num, **kw),
    "unet_3D_dtc": lambda class_num, mode, **kw: UNet3D(
        n_classes=class_num, n_heads=2, **kw),
    # UNETR and UNETR_DTC (`factory.py:67-79`): img_shape is the window
    "unetr": lambda class_num, mode, img_shape=(128, 128, 128), **kw: UNETR(
        n_classes=class_num, img_shape=img_shape, **kw),
    "unetr_dtc": lambda class_num, mode, img_shape=(128, 128, 128), **kw:
        UNETR(n_classes=class_num, img_shape=img_shape, dtc=True, **kw),
    "git_VNet": _git_vnet,
    # the dead-net tail of `networks/unet.py` (`factory.py:94-129`)
    "sep_unet_2d": lambda class_num, mode, **kw: SepUNet2D(
        n_classes=class_num, **kw),
    "unet_2d_bcp": lambda class_num, mode, **kw: UNet2DBCP(
        n_classes=class_num, **kw),
    "unet_tsne": lambda class_num, mode, **kw: UNetTsne(
        n_classes=class_num, **kw),
    "net_D": _net_d,
    "unet_3D_trilinear": lambda class_num, mode, **kw: UNet3DTrilinear(
        n_classes=class_num, **kw),
    # MONAI's SwinUNETR at its published widths; ``n_filters`` is its
    # feature_size (48)
    "swin_unetr": lambda class_num, mode, n_filters=None, **kw: SwinUNETR(
        n_classes=class_num, feature_size=n_filters or 48, **kw),
}


def create_model(net_type: str, class_num: int, mode: str = "test",
                 compute_dtype=None, device=None, **kw):
    """Build ``net_type`` on ``device`` (default: the card): ``mode="test"``
    in eval mode, ``"train"`` in train mode with dropout.
    ``compute_dtype`` (e.g. ``torch.bfloat16``) is the dtype the layers
    compute in; parameters stay f32."""
    if net_type not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown net_type {net_type!r}; have {sorted(MODEL_REGISTRY)}")
    if mode not in ("train", "test"):
        raise ValueError(f"mode must be 'train' or 'test', got {mode!r}")
    if net_type not in VNETS:
        if kw.pop("fused_bwd", False):
            raise ValueError(f"fused_bwd is the V-Net's 3^3 conv backward; "
                             f"net_type={net_type!r} has none")
        if kw.pop("remat", False):
            # the JAX trainer's refusal (`trainer.py:177-182`)
            raise ValueError(f"remat targets the V-Net pipelines; net_type="
                             f"{net_type!r} has no remat support")
    model = MODEL_REGISTRY[net_type](class_num, mode, dtype=compute_dtype,
                                     **kw)
    return model.to(resolve_device(device)).train(mode == "train")
