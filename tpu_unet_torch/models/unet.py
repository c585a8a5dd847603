"""The UNet model family as PyTorch modules (counterpart of
``tpu_unet/models/unet.py``), transposed-conv decoders.

- ``UNet(n_channels=3, n_classes=1)``: encoder 64/128/256/512/1024, 4 skip
  decoder stages, 1x1 head; 31,037,633 params at n_classes=1.
- ``SegmentationUNet``: UNet with channel dropout on the bottleneck, which is
  the identity in eval mode and takes its mask as an argument in train mode;
  31,037,828 params at 4 classes.
- ``AnomalyUNet``: shared encoder, two decoders (reconstruction -> 3-channel
  sigmoid, segmentation -> 1-channel sigmoid); 43,228,228 params.

In train mode (``model.train()``) BatchNorm normalizes by batch statistics
and updates its running statistics as flax does (``models/blocks.py``).

Inputs and outputs are NCHW. Attribute names are the reference state_dict's
(``inc``, ``down1``..``down4``, ``up1``..``up4`` or ``up1_recon``/``up1_seg``..,
``outc`` or ``outc_recon``/``outc_seg``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tpu_unet_torch.core.precision import DEFAULT_POLICY, Policy
from tpu_unet_torch.models.blocks import DoubleConv, Down, OutConv, Up


class _Ladder(nn.Module):
    """Shared encoder and decoder builders of the ladder family."""

    def __init__(self, n_channels: int, base_features: int, bilinear: bool,
                 policy: Policy):
        super().__init__()
        if bilinear:
            raise NotImplementedError(
                "bilinear decoders need ops/resize.py, which is not ported yet")
        self.policy = policy
        b = base_features
        self.inc = DoubleConv(n_channels, b, policy=policy)
        self.down1 = Down(b, 2 * b, policy=policy)
        self.down2 = Down(2 * b, 4 * b, policy=policy)
        self.down3 = Down(4 * b, 8 * b, policy=policy)
        self.down4 = Down(8 * b, 16 * b, policy=policy)

    def _add_decoder(self, suffix: str) -> None:
        b = self.inc.double_conv[0].out_channels
        for i, (cin, cout) in enumerate(((16 * b, 8 * b), (8 * b, 4 * b),
                                         (4 * b, 2 * b), (2 * b, b)), start=1):
            self.add_module(f"up{i}{suffix}", Up(cin, cout, policy=self.policy))

    def _encode(self, x: torch.Tensor):
        x1 = self.inc(self.policy.cast_to_compute(x))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        return x1, x2, x3, x4, x5

    def _decode(self, skips, suffix: str) -> torch.Tensor:
        x1, x2, x3, x4, x5 = skips
        x = getattr(self, f"up1{suffix}")(x5, x4)
        x = getattr(self, f"up2{suffix}")(x, x3)
        x = getattr(self, f"up3{suffix}")(x, x2)
        return getattr(self, f"up4{suffix}")(x, x1)


class UNet(_Ladder):
    """Standard UNet; returns logits of shape (N, n_classes, H, W)."""

    def __init__(self, n_channels: int = 3, n_classes: int = 1,
                 bilinear: bool = False, policy: Policy = DEFAULT_POLICY,
                 base_features: int = 64):
        super().__init__(n_channels, base_features, bilinear, policy)
        self._add_decoder("")
        self.outc = OutConv(base_features, n_classes, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.outc(self._decode(self._encode(x), ""))


class SegmentationUNet(UNet):
    """UNet for multi-class segmentation, with channel dropout (Dropout2d,
    reference model.py:130,146) on the bottleneck x5 only.

    The dropout holds no parameters and is the identity in eval mode. In
    train mode with ``dropout > 0`` the forward takes its draw as an
    argument, as the augment does: ``keep``, an (N, C5) bool mask of the
    bottleneck channels that survive (:meth:`sample_dropout`), and each
    kept channel is divided by 1 - rate (flax's ``Dropout``).
    """

    def __init__(self, n_channels: int = 3, n_classes: int = 4,
                 bilinear: bool = False, dropout: float = 0.1,
                 policy: Policy = DEFAULT_POLICY, base_features: int = 64):
        super().__init__(n_channels, n_classes, bilinear, policy, base_features)
        self.dropout = dropout

    @property
    def bottleneck_channels(self) -> int:
        return self.down4.maxpool_conv[1].double_conv[0].out_channels

    def sample_dropout(self, n: int, generator: torch.Generator) -> Optional[torch.Tensor]:
        """A keep mask for a batch of ``n`` on the generator's device: each
        channel survives with probability 1 - rate. None without dropout."""
        if self.dropout <= 0:
            return None
        u = torch.rand((n, self.bottleneck_channels), generator=generator,
                       device=generator.device)
        return u < 1.0 - self.dropout

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        skips = self._encode(x)
        if self.training and self.dropout > 0:
            if keep is None:
                raise ValueError("SegmentationUNet in train mode takes its dropout draw: "
                                 "forward(x, keep=model.sample_dropout(n, generator))")
            x5 = skips[4]
            if tuple(keep.shape) != tuple(x5.shape[:2]):
                raise ValueError(f"dropout keep mask {tuple(keep.shape)} for a bottleneck "
                                 f"of {tuple(x5.shape[:2])}")
            keep = keep.to(x5.device)[:, :, None, None]
            x5 = torch.where(keep, x5 / (1.0 - self.dropout), torch.zeros_like(x5))
            skips = (*skips[:4], x5)
        return self.outc(self._decode(skips, ""))


class AnomalyUNet(_Ladder):
    """Dual-decoder UNet: ``forward`` returns ``(reconstruction, anomaly_map)``,
    sigmoid-activated (N, 3, H, W) and (N, 1, H, W)."""

    def __init__(self, n_channels: int = 3, bilinear: bool = False,
                 policy: Policy = DEFAULT_POLICY, base_features: int = 64):
        super().__init__(n_channels, base_features, bilinear, policy)
        self._add_decoder("_recon")
        self._add_decoder("_seg")
        self.outc_recon = OutConv(base_features, n_channels, policy=policy)
        self.outc_seg = OutConv(base_features, 1, policy=policy)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        skips = self._encode(x)
        recon = torch.sigmoid(self.outc_recon(self._decode(skips, "_recon")))
        amap = torch.sigmoid(self.outc_seg(self._decode(skips, "_seg")))
        return recon, amap

    def score_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The reconstruction alone: encoder, recon decoder and its head. The
        segmentation decoder never runs (the JAX score program gets the same
        from XLA's dead-code elimination)."""
        return torch.sigmoid(self.outc_recon(self._decode(self._encode(x), "_recon")))


def build_model(name: str, *, n_channels: int = 3, n_classes: int = 1,
                bilinear: bool = False, dropout: float = 0.1,
                policy: Policy = DEFAULT_POLICY, base_features: int = 64):
    """Build a model by CLI name ('unet' | 'anomaly_unet' | 'seg_unet')."""
    name = name.lower()
    if name == "unet":
        return UNet(n_channels=n_channels, n_classes=n_classes, bilinear=bilinear,
                    policy=policy, base_features=base_features)
    if name == "anomaly_unet":
        return AnomalyUNet(n_channels=n_channels, bilinear=bilinear, policy=policy,
                           base_features=base_features)
    if name in ("seg_unet", "segmentation_unet"):
        return SegmentationUNet(n_channels=n_channels, n_classes=n_classes,
                                bilinear=bilinear, dropout=dropout, policy=policy,
                                base_features=base_features)
    if name in ("unetpp", "unet++", "nested_unet", "attn_unet", "attention_unet",
                "attunet"):
        raise NotImplementedError(f"model {name!r} is not ported yet")
    raise ValueError(f"Unknown model: {name!r}")
