"""Models of the port."""

from bcp_tpu_torch.models.factory import create_model
from bcp_tpu_torch.models.unet2d import UNet2D
from bcp_tpu_torch.models.vnet3d import VNet3D, VNetPancreas

__all__ = ["create_model", "UNet2D", "VNet3D", "VNetPancreas"]
