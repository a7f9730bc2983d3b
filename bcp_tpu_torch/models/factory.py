"""Model registry: ``bcp_tpu/models/factory.py`` for the port.

The port carries the LA ``"VNet"``, the ACDC ``"unet"`` and the pancreas
``"VNet_pancreas"``; the other reference models come with their slices.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from bcp_tpu_torch.device import resolve_device
from bcp_tpu_torch.models.unet2d import UNet2D
from bcp_tpu_torch.models.vnet3d import VNet3D, VNetPancreas


def _unet(class_num: int, mode: str, n_filters=None, **kw):
    """`net_factory('unet')` (`factory.py:27-33`): ``UNet_2d`` with its
    dropout in train mode; ``n_filters`` scales the whole channel ladder
    (reference: 16)."""
    if kw.pop("fused_bwd", False):
        raise ValueError("fused_bwd is the V-Net's 3^3 conv backward; the "
                         "2-D U-Net's convs are cuDNN's")
    if kw.pop("remat", False):
        # the JAX trainer's refusal (`trainer.py:177-182`)
        raise ValueError("remat targets the V-Net pipelines; "
                         "net_type='unet' has no remat support")
    if n_filters:
        kw["feature_chns"] = tuple(n_filters * 2 ** i for i in range(5))
    return UNet2D(n_classes=class_num, **kw)


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
    model = MODEL_REGISTRY[net_type](class_num, mode, dtype=compute_dtype,
                                     **kw)
    return model.to(resolve_device(device)).train(mode == "train")
