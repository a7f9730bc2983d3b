"""Models of the port."""

from bcp_tpu_torch.models.factory import MODEL_REGISTRY, create_model
from bcp_tpu_torch.models.unet2d import UNet2D
from bcp_tpu_torch.models.unet3d import UNet3D
from bcp_tpu_torch.models.unetr import UNETR
from bcp_tpu_torch.models.vnet3d import GitVNet, VNet3D, VNetPancreas

__all__ = ["create_model", "MODEL_REGISTRY", "GitVNet", "UNet2D", "UNet3D",
           "UNETR", "VNet3D", "VNetPancreas"]
