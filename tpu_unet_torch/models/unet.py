"""The UNet model family as PyTorch modules (counterpart of
``tpu_unet/models/unet.py``), with transposed-conv or bilinear decoders.

- ``UNet(n_channels=3, n_classes=1)``: encoder 64/128/256/512/1024, 4 skip
  decoder stages, 1x1 head; 31,037,633 params at n_classes=1.
- ``SegmentationUNet``: UNet with channel dropout on the bottleneck, which is
  the identity in eval mode and takes its mask as an argument in train mode;
  31,037,828 params at 4 classes.
- ``AnomalyUNet``: shared encoder, two decoders (reconstruction -> 3-channel
  sigmoid, segmentation -> 1-channel sigmoid); 43,228,228 params.

In train mode (``model.train()``) BatchNorm normalizes by batch statistics
and updates its running statistics as flax does (``models/blocks.py``).
``SegmentationUNet`` and ``AnomalyUNet`` take ``remat_full_res``, which tags
the full- and half-resolution rows (``inc``, ``down1`` and each decoder's
``up3`` and ``up4``) for a train step built with ``remat='full_res'``, as the
JAX models do; the parameters are the same.

Inputs and outputs are NCHW. Attribute names are the reference state_dict's
(``inc``, ``down1``..``down4``, ``up1``..``up4`` or ``up1_recon``/``up1_seg``..,
``outc`` or ``outc_recon``/``outc_seg``). A bilinear decoder's Up blocks have
no ``up`` child (``upK.conv.double_conv.*`` only), so a reference bilinear
``.pth`` loads with ``strict=True``. ``build_model`` also builds the attention
UNet (``models/attention.py``), UNet++ (``models/unetpp.py``), TransUNet
(``models/transunet.py``) and SegFormer (``models/segformer.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tpu_unet_torch.core.precision import DEFAULT_POLICY, Policy
from tpu_unet_torch.models.blocks import DoubleConv, Down, OutConv, Up


class _Ladder(nn.Module):
    """Shared encoder and decoder builders of the ladder family. Bilinear
    ladders halve the bottleneck and the decoder widths (``factor`` 2), as
    the reference's do."""

    def __init__(self, n_channels: int, base_features: int, bilinear: bool,
                 policy: Policy, attention: bool = False):
        super().__init__()
        self.policy, self.bilinear, self.attention = policy, bilinear, attention
        self.base_features = b = base_features
        factor = 2 if bilinear else 1
        self.inc = DoubleConv(n_channels, b, policy=policy)
        self.down1 = Down(b, 2 * b, policy=policy, level=1)
        self.down2 = Down(2 * b, 4 * b, policy=policy, level=2)
        self.down3 = Down(4 * b, 8 * b, policy=policy, level=3)
        self.down4 = Down(8 * b, 16 * b // factor, policy=policy, level=4)

    def _add_decoder(self, suffix: str) -> None:
        b, factor = self.base_features, 2 if self.bilinear else 1
        for i, (cin, cout) in enumerate(((16 * b, 8 * b // factor), (8 * b, 4 * b // factor),
                                         (4 * b, 2 * b // factor), (2 * b, b)), start=1):
            self.add_module(f"up{i}{suffix}", Up(cin, cout, self.bilinear, self.policy,
                                                 attention=self.attention, level=4 - i))

    def _tag_full_res(self, suffixes) -> None:
        """Tag the full- and half-resolution rows 'full_res': ``inc``,
        ``down1`` and ``up3``/``up4`` of each decoder (``suffixes``)."""
        self.inc.remat_tag = "full_res"
        self.down1.maxpool_conv[1].remat_tag = "full_res"
        for suffix in suffixes:
            for i in (3, 4):
                getattr(self, f"up{i}{suffix}").remat_tag = "full_res"

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
                 base_features: int = 64, attention: bool = False):
        super().__init__(n_channels, base_features, bilinear, policy, attention)
        self._add_decoder("")
        self.outc = OutConv(base_features, n_classes, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.outc(self._decode(self._encode(x), ""))


class BottleneckDropout:
    """Channel dropout (Dropout2d) of a bottleneck tensor whose mask is a
    draw: the identity in eval mode or at rate 0; in train mode ``keep``, an
    (N, C) bool mask of the channels that survive (:meth:`sample_dropout`),
    each kept channel divided by 1 - rate (flax's ``Dropout``). The class
    sets ``dropout`` and ``bottleneck_channels``."""

    dropout: float
    bottleneck_channels: int

    def sample_dropout(self, n: int, generator: torch.Generator) -> Optional[torch.Tensor]:
        """A keep mask for a batch of ``n`` on the generator's device: each
        channel survives with probability 1 - rate. None without dropout."""
        if self.dropout <= 0:
            return None
        u = torch.rand((n, self.bottleneck_channels), generator=generator,
                       device=generator.device)
        return u < 1.0 - self.dropout

    def _drop(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        if not (self.training and self.dropout > 0):
            return x
        if keep is None:
            raise ValueError(f"{type(self).__name__} in train mode takes its dropout draw: "
                             "forward(x, keep=model.sample_dropout(n, generator))")
        if tuple(keep.shape) != tuple(x.shape[:2]):
            raise ValueError(f"dropout keep mask {tuple(keep.shape)} for a bottleneck "
                             f"of {tuple(x.shape[:2])}")
        keep = keep.to(x.device)[:, :, None, None]
        return torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))


class SegmentationUNet(BottleneckDropout, UNet):
    """UNet for multi-class segmentation, with channel dropout (Dropout2d,
    reference model.py:130,146) on the bottleneck x5 only (see
    :class:`BottleneckDropout`). ``attention=True`` gates the decoder's
    skips (``models/attention.py::AttentionUNet``). ``remat_full_res`` tags
    the full- and half-resolution rows for targeted remat."""

    def __init__(self, n_channels: int = 3, n_classes: int = 4,
                 bilinear: bool = False, dropout: float = 0.1,
                 policy: Policy = DEFAULT_POLICY, base_features: int = 64,
                 attention: bool = False, *, remat_full_res: bool = False):
        super().__init__(n_channels, n_classes, bilinear, policy, base_features, attention)
        self.dropout = dropout
        self.bottleneck_channels = self.down4.maxpool_conv[1].double_conv[3].out_channels
        if remat_full_res:
            self._tag_full_res([""])

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        skips = self._encode(x)
        skips = (*skips[:4], self._drop(skips[4], keep))
        return self.outc(self._decode(skips, ""))


class AnomalyUNet(_Ladder):
    """Dual-decoder UNet: ``forward`` returns ``(reconstruction, anomaly_map)``,
    sigmoid-activated (N, 3, H, W) and (N, 1, H, W). ``remat_full_res``
    tags the full- and half-resolution rows for targeted remat."""

    def __init__(self, n_channels: int = 3, bilinear: bool = False,
                 policy: Policy = DEFAULT_POLICY, base_features: int = 64,
                 remat_full_res: bool = False):
        super().__init__(n_channels, base_features, bilinear, policy)
        self._add_decoder("_recon")
        self._add_decoder("_seg")
        self.outc_recon = OutConv(base_features, n_channels, policy=policy)
        self.outc_seg = OutConv(base_features, 1, policy=policy)
        if remat_full_res:
            self._tag_full_res(["_recon", "_seg"])

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


UNETPP_NAMES = ("unetpp", "unet++", "nested_unet")
ATTN_NAMES = ("attn_unet", "attention_unet", "attunet")
TRANSUNET_NAMES = ("transunet",)
SEGFORMER_NAMES = ("segformer",)


def trains_only(name: str) -> bool:
    """Whether the model that :func:`build_model` builds by ``name`` trains
    through the seg step alone, on whole images and whole channels: its
    class sets ``train_only`` (TransUNet, SegFormer), which
    ``models/blocks.py::refuse_train_only`` reads on a built model."""
    name = name.lower()
    if name in TRANSUNET_NAMES:
        from tpu_unet_torch.models.transunet import TransUNet as cls
    elif name in SEGFORMER_NAMES:
        from tpu_unet_torch.models.segformer import SegFormer as cls
    else:
        return False
    return cls.train_only


def check_model_flags(name: str, deep_supervision: bool = False, heads: int = 4, *,
                      n_space: int = 1, n_model: int = 1) -> None:
    """The JAX package's ValueErrors for ``deep_supervision`` or ``heads``
    outside UNet++ with deep supervision, and a train-only transformer's
    (TransUNet's, SegFormer's) for a 'space' or 'model' axis wider than 1
    (raised by :func:`build_model`; the CLIs call it before they write
    anything)."""
    is_unetpp = name.lower() in UNETPP_NAMES
    if deep_supervision and not is_unetpp:
        raise ValueError(
            f"deep_supervision is only supported by --model unetpp, got {name!r}")
    if heads != 4 and not (is_unetpp and deep_supervision):
        raise ValueError(
            "heads selects a UNet++ deep-supervision inference head; it "
            f"requires --model unetpp with deep_supervision (got model={name!r}, "
            f"deep_supervision={deep_supervision})")
    if trains_only(name) and (n_space > 1 or n_model > 1):
        raise ValueError(f"{name.lower()} trains on whole images and whole channels: "
                         f"--n_space {n_space} and --n_model {n_model} must be 1")


def build_model(name: str, *, n_channels: int = 3, n_classes: int = 1,
                bilinear: bool = False, dropout: float = 0.1,
                policy: Policy = DEFAULT_POLICY, base_features: int = 64,
                deep_supervision: bool = False, heads: int = 4,
                image_size_hw: Optional[Tuple[int, int]] = None, **widths):
    """Build a model by CLI name ('unet' | 'anomaly_unet' | 'seg_unet' |
    'unetpp' | 'attn_unet' | 'transunet' | 'segformer'). ``deep_supervision``
    and ``heads`` (the UNet++ inference head: 4 averages the head logits,
    k < 4 is head X[0][k] alone) are UNet++'s and raise the JAX package's
    ValueError elsewhere. TransUNet takes ``image_size_hw`` (its position
    table has a row per 16x16 pixels), ``base_features`` as its hybrid
    ResNet's width and its other widths as keywords (``models/transunet.py``).
    SegFormer takes its widths as keywords (``models/segformer.py``; MiT-B5
    and a 768 head by default), ``dropout`` as its head's Dropout2d rate,
    and ignores ``base_features`` and ``image_size_hw``, as the ladders
    ignore ``image_size_hw``."""
    check_model_flags(name, deep_supervision, heads)
    name = name.lower()
    if name in TRANSUNET_NAMES:
        from tpu_unet_torch.models.transunet import TransUNet
        if image_size_hw is None:
            raise ValueError("transunet needs image_size_hw: its position table has one "
                             "row per 16x16 pixels of the image")
        return TransUNet(image_size_hw, n_channels=n_channels, n_classes=n_classes,
                         dropout=dropout, policy=policy, width=base_features, **widths)
    if name in SEGFORMER_NAMES:
        from tpu_unet_torch.models.segformer import SegFormer
        return SegFormer(n_channels=n_channels, n_classes=n_classes, dropout=dropout,
                         policy=policy, **widths)
    if widths:
        raise TypeError(f"build_model({name!r}) got a transformer's keywords {sorted(widths)}")
    if name in UNETPP_NAMES:
        from tpu_unet_torch.models.unetpp import UNetPlusPlus
        return UNetPlusPlus(n_channels=n_channels, n_classes=n_classes, bilinear=bilinear,
                            dropout=dropout, deep_supervision=deep_supervision, heads=heads,
                            policy=policy, base_features=base_features)
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
    if name in ATTN_NAMES:
        from tpu_unet_torch.models.attention import AttentionUNet
        return AttentionUNet(n_channels=n_channels, n_classes=n_classes, bilinear=bilinear,
                             dropout=dropout, policy=policy, base_features=base_features)
    raise ValueError(f"Unknown model: {name!r}")
