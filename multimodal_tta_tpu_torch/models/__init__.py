"""Models of the port; importing the package registers them under the
reference's names (``get_model(name).from_config(cfg, dtype=, remat=,
device=, seed=)``)."""

from .densenet import DenseNet
from .efficientnet import EfficientNet
from .resnet import ResNet
from .segresnet import SegResNet
from .swin_unetr import SwinUNETR
from .unet3d import UNet3D
from .unet3d_ws import UNet3DWS
from .unet_multimodal_latefusion import MultimodalUNetLateFusion
from .unet_multimodal_midfusion import MultimodalUNetMidFusion
from .unetr import UNETR
from .vit import ViT

__all__ = ["UNet3D", "MultimodalUNetMidFusion", "MultimodalUNetLateFusion", "UNet3DWS", "SegResNet", "UNETR",
           "SwinUNETR", "ResNet", "DenseNet", "EfficientNet", "ViT"]
