"""The ladder UNets in plain float32 PyTorch (Ronneberger et al.,
arXiv:1505.04597, with the reference repository's variants):
SegmentationUNet (one decoder, channel dropout on the bottleneck under a
given keep mask) and AnomalyUNet (a shared encoder, a reconstruction and a
segmentation decoder, each head a sigmoid).

Parameters are a dict of tensors named as the reference repository's
state_dict (``inc.double_conv.0.weight``, ``up1_recon.up.weight``, ...).
Tensors are NCHW. A block is (3x3 conv without bias, BatchNorm, ReLU) twice;
a level-down is a 2x2 max-pool; a level-up is a 2x2 stride-2 transposed
conv, concatenated after the skip. BatchNorm as flax configures it: eps
1e-5; in train mode it normalises by the batch mean and biased variance and
moves the running statistics by 0.1 towards them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
MOMENTUM = 0.1


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


class Ladder:
    """One ladder UNet of a configuration (its ``model``, ``base_features``,
    ``n_channels``, ``n_classes``, ``dropout``)."""

    def __init__(self, config: Dict):
        self.base = int(config["base_features"])
        self.n_channels = int(config.get("n_channels", 3))
        model = config["model"]
        if model == "anomaly_unet":
            # (state_dict suffix, head channels, sigmoid head)
            self.decoders = (("_recon", self.n_channels, True), ("_seg", 1, True))
            self.dropout = 0.0
        elif model == "seg_unet":
            self.decoders = (("", int(config["n_classes"]), False),)
            self.dropout = float(config.get("dropout", 0.0))
        else:
            raise ValueError(f"no ladder reference for model {model!r}")

    def blocks(self) -> List[Tuple[str, int, int]]:
        """(prefix, in channels, out channels) of every double-conv block."""
        b = self.base
        out = [("inc", self.n_channels, b)]
        out += [(f"down{i}.maxpool_conv.1", b << (i - 1), b << i) for i in range(1, 5)]
        for suffix, _, _ in self.decoders:
            out += [(f"up{i}{suffix}.conv", b << (5 - i), b << (4 - i)) for i in range(1, 5)]
        return out

    def specs(self) -> List[Tuple[str, Tuple[int, ...], str]]:
        """(name, shape, role) of every tensor of the state_dict. Roles:
        conv, bn_weight, bn_bias, running_mean, running_var, count,
        up_weight, head_weight, bias."""
        out = []
        for prefix, cin, cout in self.blocks():
            for i, ci in ((0, cin), (3, cout)):
                bn = f"{prefix}.double_conv.{i + 1}"
                out += [(f"{prefix}.double_conv.{i}.weight", (cout, ci, 3, 3), "conv"),
                        (f"{bn}.weight", (cout,), "bn_weight"),
                        (f"{bn}.bias", (cout,), "bn_bias"),
                        (f"{bn}.running_mean", (cout,), "running_mean"),
                        (f"{bn}.running_var", (cout,), "running_var"),
                        (f"{bn}.num_batches_tracked", (), "count")]
        b = self.base
        for suffix, k, _ in self.decoders:
            for i in range(1, 5):
                cin = b << (5 - i)
                out += [(f"up{i}{suffix}.up.weight", (cin, cin // 2, 2, 2), "up_weight"),
                        (f"up{i}{suffix}.up.bias", (cin // 2,), "bias")]
            out += [(f"outc{suffix}.conv.weight", (k, b, 1, 1), "head_weight"),
                    (f"outc{suffix}.conv.bias", (k,), "bias")]
        return out

    def fold(self, p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """BatchNorm's eval form folded into each conv: w * g / sqrt(var +
        eps) per output channel and the bias beta - mean * g / sqrt(var +
        eps). The level-ups and heads are copied."""
        out = {}
        for name, _, role in self.specs():
            if role == "conv":
                prefix, index, _ = name.rsplit(".", 2)
                bn = f"{prefix}.{int(index) + 1}"
                inv = p[f"{bn}.weight"] * torch.rsqrt(p[f"{bn}.running_var"] + EPS)
                out[name] = p[name] * inv[:, None, None, None]
                out[f"{prefix}.{index}.bias"] = p[f"{bn}.bias"] - p[f"{bn}.running_mean"] * inv
            elif role in ("up_weight", "head_weight", "bias"):
                out[name] = p[name]
        return out

    def forward(self, p: Dict[str, torch.Tensor], x: torch.Tensor, *, bn: str = "eval",
                keep: Optional[torch.Tensor] = None,
                lowp: Callable[[torch.Tensor], torch.Tensor] = _same,
                tap: Optional[Callable[[str, torch.Tensor], None]] = None,
                decoders: Optional[Tuple] = None):
        """The heads' outputs (NCHW, a tuple in the order of ``decoders``)
        and, under ``bn='train'``, the moved running statistics by name.

        ``bn``: 'train' (batch statistics), 'eval' (running statistics) or
        'folded' (``p`` from :meth:`fold`: biased convs, no BatchNorm).
        ``keep``: the bottleneck dropout's (N, C) keep mask, train mode only.
        ``lowp`` rounds every conv's input, weight and output (the
        controls' lower precision, where the program computes in bf16);
        ``tap(tag, tensor)`` sees every block's ReLU outputs
        (``<prefix>.relu0``, ``<prefix>.relu3``) and every level-up's output
        (``<up>.up``)."""
        h, w = x.shape[2:]
        if h % 16 or w % 16:
            raise ValueError(f"the ladder reference takes sizes divisible by 16, got {h}x{w}")
        stats: Dict[str, torch.Tensor] = {}

        def block(prefix, t):
            for i in (0, 3):
                conv = f"{prefix}.double_conv.{i}"
                y = lowp(F.conv2d(lowp(t), lowp(p[f"{conv}.weight"]),
                                  p[f"{conv}.bias"] if bn == "folded" else None, padding=1))
                if bn != "folded":
                    y = _batch_norm(p, f"{prefix}.double_conv.{i + 1}", y, bn == "train", stats)
                t = F.relu(y)
                if tap is not None:
                    tap(f"{prefix}.relu{i}", t)
            return t

        skips = [block("inc", x)]
        for i in range(1, 5):
            skips.append(block(f"down{i}.maxpool_conv.1", F.max_pool2d(skips[-1], 2)))
        if self.dropout > 0 and bn == "train":
            if keep is None:
                raise ValueError("train mode takes the bottleneck dropout's keep mask")
            skips[4] = torch.where(keep[:, :, None, None], skips[4] / (1.0 - self.dropout),
                                   torch.zeros((), device=x.device))
        outs = []
        for suffix, _, sigmoid in decoders or self.decoders:
            y = skips[4]
            for i in range(1, 5):
                up = f"up{i}{suffix}"
                u = lowp(F.conv_transpose2d(lowp(y), lowp(p[f"{up}.up.weight"]),
                                            p[f"{up}.up.bias"], stride=2))
                if tap is not None:
                    tap(f"{up}.up", u)
                y = block(f"{up}.conv", torch.cat([skips[4 - i], u], dim=1))
            head = lowp(F.conv2d(lowp(y), lowp(p[f"outc{suffix}.conv.weight"]),
                                 p[f"outc{suffix}.conv.bias"]))
            outs.append(torch.sigmoid(head) if sigmoid else head)
        return tuple(outs), stats


def _batch_norm(p, name, y, train: bool, stats) -> torch.Tensor:
    weight, bias = p[f"{name}.weight"], p[f"{name}.bias"]
    if not train:
        return F.batch_norm(y, p[f"{name}.running_mean"], p[f"{name}.running_var"], weight,
                            bias, False, 0.0, EPS)
    with torch.no_grad():
        mean = y.mean(dim=(0, 2, 3))
        var = y.var(dim=(0, 2, 3), unbiased=False)
        stats[f"{name}.running_mean"] = (1 - MOMENTUM) * p[f"{name}.running_mean"] + MOMENTUM * mean
        stats[f"{name}.running_var"] = (1 - MOMENTUM) * p[f"{name}.running_var"] + MOMENTUM * var
    # batch statistics (no running statistics given): the biased variance
    return F.batch_norm(y, None, None, weight, bias, True, 0.0, EPS)


def build(config: Dict) -> Ladder:
    """The reference model of a configuration that names this module."""
    return Ladder(config)
