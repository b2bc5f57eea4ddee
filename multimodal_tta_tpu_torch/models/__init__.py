"""Models of the port; importing the package registers them under the
reference's names (``get_model(name).from_config(cfg, dtype=, remat=,
device=, seed=)``)."""

from .densenet import DenseNet
from .efficientnet import EfficientNet
from .layers import ConvBlock, Norm, ResidualUnit, TransposedConvUp, UpSample, get_act
from .mogvae import VAEDeltaMoG
from .resnet import ResNet, get_resnet_model
from .segresnet import SegResNet
from .swin_unetr import SwinUNETR
from .unet3d import UNet3D
from .unet3d_ws import UNet3DWS
from .unet_multimodal_latefusion import MultimodalUNetLateFusion
from .unet_multimodal_midfusion import CompositionalLayer, DecoderStage, MultimodalUNetMidFusion, SpecificEncoder
from .unetr import UNETR
from .vit import ViT, get_vit_model

__all__ = ["ConvBlock", "ResidualUnit", "UpSample", "TransposedConvUp", "Norm", "get_act", "UNet3D",
           "MultimodalUNetMidFusion", "SpecificEncoder", "CompositionalLayer", "DecoderStage",
           "MultimodalUNetLateFusion", "UNet3DWS", "SegResNet", "UNETR", "SwinUNETR", "ResNet", "DenseNet",
           "EfficientNet", "ViT", "VAEDeltaMoG", "get_resnet_model", "get_vit_model"]
