from tpu_unet_torch.models.blocks import DoubleConv, Down, OutConv, Up
from tpu_unet_torch.models.unet import AnomalyUNet, SegmentationUNet, UNet, build_model

__all__ = ["DoubleConv", "Down", "Up", "OutConv", "UNet", "SegmentationUNet",
           "AnomalyUNet", "build_model"]
