from tpu_unet_torch.models.blocks import DoubleConv, Down, OutConv, Up
from tpu_unet_torch.models.unet import AnomalyUNet, SegmentationUNet, UNet, build_model
from tpu_unet_torch.models.unetpp import UNetPlusPlus
from tpu_unet_torch.models.attention import AttentionGate, AttentionUNet

__all__ = ["DoubleConv", "Down", "Up", "OutConv", "UNet", "SegmentationUNet",
           "AnomalyUNet", "build_model", "UNetPlusPlus", "AttentionGate", "AttentionUNet"]
