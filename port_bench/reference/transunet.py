"""TransUNet, R50-ViT-B/16 hybrid (Chen et al., arXiv:2102.04306; the
public code's ``networks/vit_seg_modeling.py``,
``vit_seg_modeling_resnet_skip.py`` and
``vit_seg_configs.py::get_r50_b16_config``), in plain float32 PyTorch.

Parameters are a dict of tensors named as the public code's state_dict
(``transformer.embeddings.hybrid_model.root.conv.weight``,
``transformer.encoder.layer.0.attn.query.weight``, ``decoder.conv_more.0.weight``,
``segmentation_head.0.weight``, ...). Tensors are NCHW; tokens (N, T, D).

- Hybrid encoder: ResNet-50 v2 (BiT), its first three stages. Every conv
  standardises its weight per output channel, ``(W - mean) / sqrt(var +
  1e-5)`` over (in, kh, kw), biased variance, and has no bias. Root:
  ``relu(GN32(conv7x7/2))``, a 3x3/2 max-pool without padding; each unit
  ``relu(r + GN(conv1x1(relu(GN(conv3x3/s(relu(GN(conv1x1(x)))))))))`` with
  mid width ``cout / 4``, the residual ``r`` being ``x`` or, in a stage's
  first unit, ``GN(cout groups, eps 1e-5)(conv1x1/s(x))``; GroupNorm eps
  1e-6 elsewhere. Skips: the root's output, stage 1's and stage 2's.
- Embedding: a biased 1x1 conv to ``hidden_size``, a learned position table,
  dropout.
- Encoder: ``num_layers`` pre-LN blocks (eps 1e-6): ``x + out(attn(LN(x)))``,
  the attention written out as ``softmax(Q K^T / sqrt(d)) V`` per head, and
  ``x + drop(fc2(drop(gelu(fc1(LN(x))))))`` with erf GELU; a final LN.
- Decoder: the tokens as a map, ``conv_more`` (3x3 conv, BatchNorm, ReLU to
  512), four blocks of a 2x bilinear upsample (align corners), the skip
  concatenated after it, and two 3x3 conv-BN-ReLU; a biased 3x3 head.
  BatchNorm as ``ladder.py``'s (eps 1e-5, momentum 0.1, biased variance).

Dropout takes given keep masks (the embedding's, then fc1's and fc2's of each
block) and applies each as ``x * keep / (1 - rate)``.

Departures from the public code:
- the max-pool leaves stage 1 one row and column short; its skip is
  zero-padded at the bottom and right to H/4 and W/4 each, where the public
  code pads both sides to the input's H/4 (it assumes a square image);
- the tokens go back to a (H/16, W/16) map, where the public code takes the
  square root of their count;
- the benchmark's training cells step with Adam (``adam.py``), where the
  paper trains with SGD (lr 0.01, momentum 0.9).

Under autograd each unit, block and decoder block is checkpointed
(``torch.utils.checkpoint``), so that a float32 step at a cell's batch fits
on one card beside nothing else.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference.ladder import _batch_norm

STD_EPS = 1e-5
GN_GROUPS = 32
GN_EPS = 1e-6
LN_EPS = 1e-6
HYBRID = "transformer.embeddings.hybrid_model"
LAYER = "transformer.encoder.layer"


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


class TransUNetRef:
    """The TransUNet of a configuration: ``base_features`` (the ResNet's
    width), ``resnet_units``, ``hidden_size``,
    ``num_layers``, ``num_heads``, ``mlp_dim``, ``decoder_channels``,
    ``skip_channels``, ``n_skip``, ``n_channels``, ``n_classes``,
    ``dropout``, ``image_height``, ``image_width``."""

    def __init__(self, config: Dict):
        self.width = int(config["base_features"])
        self.units = tuple(config["resnet_units"])
        self.hidden = int(config["hidden_size"])
        self.layers = int(config["num_layers"])
        self.heads = int(config["num_heads"])
        self.mlp = int(config["mlp_dim"])
        self.decoder = tuple(config["decoder_channels"])
        self.skips = skip_widths(config)
        self.n_channels = int(config.get("n_channels", 3))
        self.n_classes = int(config["n_classes"])
        self.dropout = float(config.get("dropout", 0.0))
        self.h, self.w = int(config["image_height"]), int(config["image_width"])
        self.grid = (self.h // 16, self.w // 16)

    def _stages(self) -> List[List[Tuple[str, int, int, int]]]:
        """(prefix, in, out, stride) of every unit of each stage of the
        hybrid ResNet."""
        out, cin = [], self.width
        for s, n in enumerate(self.units):
            cout = self.width * 4 << s
            out.append([(f"{HYBRID}.body.block{s + 1}.unit{u + 1}", cin if u == 0 else cout,
                         cout, 2 if s > 0 and u == 0 else 1) for u in range(n)])
            cin = cout
        return out

    def specs(self) -> List[Tuple[str, Tuple[int, ...], str]]:
        """(name, shape, role) of every tensor of the state_dict. Roles: conv
        (3x3 and 7x7), head_weight (1x1 convs and linears: std
        1/sqrt(fan in)), bn_weight (norm scales), bn_bias (norm shifts and
        the position table), bias, running_mean, running_var, count."""
        out = []

        def norm(name, c):
            out.extend([(f"{name}.weight", (c,), "bn_weight"), (f"{name}.bias", (c,), "bn_bias")])

        def linear(name, cin, cout):
            out.extend([(f"{name}.weight", (cout, cin), "head_weight"),
                        (f"{name}.bias", (cout,), "bias")])

        def conv_bn(name, cin, cout):
            out.append((f"{name}.0.weight", (cout, cin, 3, 3), "conv"))
            norm(f"{name}.1", cout)
            out.extend([(f"{name}.1.running_mean", (cout,), "running_mean"),
                        (f"{name}.1.running_var", (cout,), "running_var"),
                        (f"{name}.1.num_batches_tracked", (), "count")])

        d = self.hidden
        out.append(("transformer.embeddings.position_embeddings",
                    (1, self.grid[0] * self.grid[1], d), "bn_bias"))
        out.append((f"{HYBRID}.root.conv.weight", (self.width, self.n_channels, 7, 7), "conv"))
        norm(f"{HYBRID}.root.gn", self.width)
        for prefix, cin, cout, stride in (u for stage in self._stages() for u in stage):
            mid = cout // 4
            out.append((f"{prefix}.conv1.weight", (mid, cin, 1, 1), "head_weight"))
            norm(f"{prefix}.gn1", mid)
            out.append((f"{prefix}.conv2.weight", (mid, mid, 3, 3), "conv"))
            norm(f"{prefix}.gn2", mid)
            out.append((f"{prefix}.conv3.weight", (cout, mid, 1, 1), "head_weight"))
            norm(f"{prefix}.gn3", cout)
            if stride != 1 or cin != cout:
                out.append((f"{prefix}.downsample.weight", (cout, cin, 1, 1), "head_weight"))
                norm(f"{prefix}.gn_proj", cout)
        out.extend([("transformer.embeddings.patch_embeddings.weight",
                     (d, self.width * 4 << (len(self.units) - 1), 1, 1), "head_weight"),
                    ("transformer.embeddings.patch_embeddings.bias", (d,), "bias")])
        for i in range(self.layers):
            b = f"{LAYER}.{i}"
            norm(f"{b}.attention_norm", d)
            for k in ("query", "key", "value", "out"):
                linear(f"{b}.attn.{k}", d, d)
            norm(f"{b}.ffn_norm", d)
            linear(f"{b}.ffn.fc1", d, self.mlp)
            linear(f"{b}.ffn.fc2", self.mlp, d)
        norm("transformer.encoder.encoder_norm", d)
        conv_bn("decoder.conv_more", d, 512)
        for i, (cin, cout, skip) in enumerate(zip((512, *self.decoder[:-1]), self.decoder,
                                                  self.skips)):
            conv_bn(f"decoder.blocks.{i}.conv1", cin + skip, cout)
            conv_bn(f"decoder.blocks.{i}.conv2", cout, cout)
        out.extend([("segmentation_head.0.weight", (self.n_classes, self.decoder[-1], 3, 3),
                     "conv"),
                    ("segmentation_head.0.bias", (self.n_classes,), "bias")])
        return out

    def forward(self, p: Dict[str, torch.Tensor], x: torch.Tensor, *, bn: str = "eval",
                keep: Optional[Sequence[torch.Tensor]] = None,
                lowp: Callable[[torch.Tensor], torch.Tensor] = _same):
        """The head's logits (a 1-tuple, NCHW) and, under ``bn='train'``, the
        moved BatchNorm running statistics by name. ``bn``: 'train' (batch
        statistics; dropout under ``keep``, the masks in the order above) or
        'eval'. ``lowp`` rounds every conv's and linear's input, weight and
        output and both attention products' operands and outputs (the
        control's lower precision, where the program computes in bf16)."""
        h, w = x.shape[2:]
        if (h, w) != (self.h, self.w):
            raise ValueError(f"the reference is built for {self.h}x{self.w}, got {h}x{w}")
        train = bn == "train"
        if train and self.dropout > 0 and keep is None:
            raise ValueError("train mode takes the dropout keep masks")
        keep = list(keep) if train and self.dropout > 0 else [None] * (1 + 2 * self.layers)
        stats: Dict[str, torch.Tensor] = {}
        run = (lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)) \
            if torch.is_grad_enabled() else (lambda fn, *a: fn(*a))

        def std_conv(t, name, stride=1, padding=0):
            wt = p[name]
            var, mean = torch.var_mean(wt, dim=(1, 2, 3), keepdim=True, unbiased=False)
            wt = (wt - mean) / torch.sqrt(var + STD_EPS)
            return lowp(F.conv2d(lowp(t), lowp(wt), None, stride, padding))

        def gn(t, name, groups=GN_GROUPS, eps=GN_EPS):
            return F.group_norm(t, groups, p[f"{name}.weight"], p[f"{name}.bias"], eps)

        def linear(t, name):
            return lowp(F.linear(lowp(t), lowp(p[f"{name}.weight"]), p[f"{name}.bias"]))

        def layer_norm(t, name):
            return F.layer_norm(t, (self.hidden,), p[f"{name}.weight"], p[f"{name}.bias"],
                                LN_EPS)

        def drop(t, k):
            return t if k is None else t * k / (1.0 - self.dropout)

        def unit(t, prefix, cin, cout, stride):
            if stride != 1 or cin != cout:
                r = gn(std_conv(t, f"{prefix}.downsample.weight", stride), f"{prefix}.gn_proj",
                       groups=cout, eps=1e-5)
            else:
                r = t
            y = F.relu(gn(std_conv(t, f"{prefix}.conv1.weight"), f"{prefix}.gn1"))
            y = F.relu(gn(std_conv(y, f"{prefix}.conv2.weight", stride, 1), f"{prefix}.gn2"))
            return F.relu(r + gn(std_conv(y, f"{prefix}.conv3.weight"), f"{prefix}.gn3"))

        def block(t, i, k1, k2):
            b = f"{LAYER}.{i}"
            n, tokens, d = t.shape
            y = layer_norm(t, f"{b}.attention_norm")

            def heads(z):
                return z.view(n, tokens, self.heads, d // self.heads).transpose(1, 2)

            q, k, v = (heads(linear(y, f"{b}.attn.{s}")) for s in ("query", "key", "value"))
            scores = lowp(lowp(q) @ lowp(k).transpose(-1, -2)) / (d // self.heads) ** 0.5
            o = lowp(lowp(torch.softmax(scores, dim=-1)) @ lowp(v))
            t = t + linear(o.transpose(1, 2).reshape(n, tokens, d), f"{b}.attn.out")
            y = layer_norm(t, f"{b}.ffn_norm")
            y = drop(F.gelu(linear(y, f"{b}.ffn.fc1")), k1)
            return t + drop(linear(y, f"{b}.ffn.fc2"), k2)

        def conv_bn_relu(t, name):
            y = lowp(F.conv2d(lowp(t), lowp(p[f"{name}.0.weight"]), None, padding=1))
            return F.relu(_batch_norm(p, f"{name}.1", y, train, stats))

        def decoder_block(t, i, *skip):
            t = F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=True)
            if skip:
                t = torch.cat([t, skip[0]], dim=1)
            t = conv_bn_relu(t, f"decoder.blocks.{i}.conv1")
            return conv_bn_relu(t, f"decoder.blocks.{i}.conv2")

        y = F.relu(gn(std_conv(x, f"{HYBRID}.root.conv.weight", 2, 3), f"{HYBRID}.root.gn"))
        skips = [y]
        y = F.max_pool2d(y, 3, 2)
        stages = self._stages()
        for s, stage in enumerate(stages):
            for u in stage:
                y = run(unit, y, *u)
            if s < len(stages) - 1:
                hh, ww = h // (4 << s), w // (4 << s)
                skips.append(F.pad(y, (0, ww - y.shape[3], 0, hh - y.shape[2])))
        skips = skips[::-1]
        n = x.shape[0]
        y = lowp(F.conv2d(lowp(y), lowp(p["transformer.embeddings.patch_embeddings.weight"]),
                          p["transformer.embeddings.patch_embeddings.bias"]))
        t = y.flatten(2).transpose(1, 2)
        t = drop(t + p["transformer.embeddings.position_embeddings"], keep[0])
        for i in range(self.layers):
            t = run(block, t, i, keep[1 + 2 * i], keep[2 + 2 * i])
        t = layer_norm(t, "transformer.encoder.encoder_norm")
        y = t.transpose(1, 2).reshape(n, self.hidden, *self.grid)
        y = run(conv_bn_relu, y, "decoder.conv_more")
        for i, skip in enumerate(self.skips):
            y = run(decoder_block, y, i, *([skips[i]] if skip else []))
        logits = lowp(F.conv2d(lowp(y), lowp(p["segmentation_head.0.weight"]),
                               p["segmentation_head.0.bias"], padding=1))
        return (logits,), stats


def skip_widths(config: Dict) -> Tuple[int, ...]:
    """The skip width each decoder block takes: ``skip_channels`` with those
    from the ``n_skip``-th on set to 0, as the public code's DecoderCup does."""
    return tuple(c if i < config["n_skip"] else 0
                 for i, c in enumerate(config["skip_channels"]))


def build(config: Dict) -> TransUNetRef:
    """The reference model of a configuration that names this module."""
    return TransUNetRef(config)
