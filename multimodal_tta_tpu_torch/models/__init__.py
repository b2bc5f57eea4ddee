"""Models of the port; importing the package registers them."""

from .unet3d import UNet3D

__all__ = ["UNet3D"]
