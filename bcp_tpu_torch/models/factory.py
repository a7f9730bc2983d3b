"""Model registry: ``bcp_tpu/models/factory.py`` for the port.

This slice carries the LA ``"VNet"`` in eval mode only; the other
reference models come with their slices.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from bcp_tpu_torch.device import resolve_device
from bcp_tpu_torch.models.vnet3d import VNet3D

MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {
    # `net_factory('VNet')` (`net_factory.py:8-11`): batchnorm; its dropout
    # is off in test-mode construction
    "VNet": lambda class_num, **kw: VNet3D(n_classes=class_num, **kw),
}


def create_model(net_type: str, class_num: int, mode: str = "test",
                 compute_dtype=None, device=None, **kw):
    """Build ``net_type`` in eval mode on ``device`` (default: the card).
    ``compute_dtype`` (e.g. ``torch.bfloat16``) is the dtype the layers
    compute in; parameters stay f32."""
    if net_type not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown net_type {net_type!r}; have {sorted(MODEL_REGISTRY)}")
    if mode != "test":
        raise NotImplementedError(
            "the port builds models for inference only; training comes "
            "with the training slice")
    model = MODEL_REGISTRY[net_type](class_num, dtype=compute_dtype, **kw)
    return model.to(resolve_device(device)).eval()
