"""SegFormer, a MiT encoder and the all-MLP head (Xie et al.,
arXiv:2105.15203; the public code's
``mmseg/models/backbones/mix_transformer.py::mit_b5``,
``mmseg/models/decode_heads/segformer_head.py`` and
``local_configs/segformer/B5/segformer.b5.1024x1024.city.160k.py``), in plain
float32 PyTorch.

Parameters are a dict of tensors named as mmseg's state_dict
(``backbone.patch_embed1.proj.weight``, ``backbone.block3.17.attn.kv.weight``,
``backbone.block1.0.mlp.dwconv.dwconv.weight``, ``backbone.norm4.weight``,
``decode_head.linear_c2.proj.weight``, ``decode_head.linear_fuse.conv.weight``,
``decode_head.linear_fuse.bn.running_mean``, ``decode_head.linear_pred.weight``,
...). Tensors are NCHW; tokens (N, T, C), T = H W in row-major order.

- Encoder: four stages of width ``embed_dims[i]``. Each embeds the previous
  map (the image first) by a biased conv k x k, stride s, padding k // 2
  (k 7, s 4, then k 3, s 2), flattens it to tokens and applies LayerNorm (eps
  1e-5); then ``depths[i]`` pre-LN blocks (eps 1e-6):
  ``x = x + dp(attn(LN1(x)))``, ``x = x + dp(mlp(LN2(x)))``; then LayerNorm
  (eps 1e-6) and the tokens as the stage's map.
  - ``attn``: ``q = Linear(C, C)(x)``; with the stage's ratio R > 1,
    ``x_r = LN(eps 1e-5)(Conv2d(C, C, R, stride R)(x as a map))`` as tokens,
    else ``x_r = x``; ``k, v = split(Linear(C, 2C)(x_r))`` (K the first C
    outputs); per head of 64 ``softmax(q k^T / sqrt(d)) v``, written out;
    ``Linear(C, C)``.
  - ``mlp``: ``fc2(gelu(dwconv(fc1(x))))``, erf GELU, fc1 to ``mlp_ratios[i]``
    C, a biased depthwise 3x3 conv (padding 1) on the tokens as a map.
  - ``dp``: block j (of all, from 0) has the rate ``linspace(0,
    drop_path_rate, sum(depths))[j]`` (float32); each branch of a block of
    nonzero rate is multiplied by its (N,) keep mask over ``1 - rate``.
- Head (embedding E): per stage ``Linear(C_i, E)`` over its tokens, as a map;
  stages 2-4 resized to stage 1's size by ``F.interpolate(mode='bilinear',
  align_corners=False)``; concatenated [c4, c3, c2, c1]; a bias-free 1x1 conv
  to E, BatchNorm (``ladder.py``'s: eps 1e-5, momentum 0.1, biased variance),
  ReLU; Dropout2d under an (N, E) keep mask over ``1 - dropout``; a biased 1x1
  conv to the classes; the logits resized to the input's size the same way.

Dropout takes given keep masks, in order: the two of each block of nonzero
rate, then the head's.

``specs()`` gives each tensor a role that ``inputs.weights`` draws: ``conv``
for the patch embeddings, the reduction convs and the depthwise convs, whose
scale assumes 9 taps of the conv's second dimension whatever the kernel size
(every one of them feeds a LayerNorm, or is depthwise with 9 taps of one
channel); ``head_weight`` for the linears and the 1x1 convs; ``bn_weight`` and
``bn_bias`` for every norm's scale and shift.

Departures from the public code: the benchmark's training cells step with
Adam and L2 decay (``adam.py``), where the published config trains with AdamW
(lr 6e-5, decay 0.01, the head's lr x10); the augment is the benchmark's
seg augment (``augment.py``), not mmseg's resize-crop-flip-photometric
pipeline; the loss is the seg cells' CE + Dice, not CE alone.

Under autograd every block and the head are checkpointed
(``torch.utils.checkpoint``), so that a float32 step at the cell's batch fits
on one card beside nothing else.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference.ladder import _batch_norm

EMBED_LN_EPS = 1e-5
LN_EPS = 1e-6


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def drop_path_rates(config: Dict) -> List[float]:
    """Each block's stochastic-depth rate, over the stages in order."""
    return torch.linspace(0, float(config["drop_path_rate"]), sum(config["depths"]),
                          device="cpu").tolist()


class SegFormerRef:
    """The SegFormer of a configuration: ``embed_dims``, ``num_heads``,
    ``mlp_ratios``, ``depths``, ``sr_ratios``, ``drop_path_rate``,
    ``embedding_dim``, ``dropout``, ``n_channels``, ``n_classes``,
    ``image_height``, ``image_width``."""

    def __init__(self, config: Dict):
        self.dims = tuple(config["embed_dims"])
        self.heads = tuple(config["num_heads"])
        self.ratios = tuple(config["mlp_ratios"])
        self.depths = tuple(config["depths"])
        self.sr = tuple(config["sr_ratios"])
        self.rates = drop_path_rates(config)
        self.embed = int(config["embedding_dim"])
        self.n_channels = int(config.get("n_channels", 3))
        self.n_classes = int(config["n_classes"])
        self.dropout = float(config.get("dropout", 0.0))
        self.h, self.w = int(config["image_height"]), int(config["image_width"])

    def n_masks(self) -> int:
        """The keep masks a train-mode forward takes."""
        return 2 * sum(r > 0 for r in self.rates) + (self.dropout > 0)

    def specs(self) -> List[Tuple[str, Tuple[int, ...], str]]:
        """(name, shape, role) of every tensor of the state_dict (module
        docstring)."""
        out = []

        def norm(name, c):
            out.extend([(f"{name}.weight", (c,), "bn_weight"), (f"{name}.bias", (c,), "bn_bias")])

        def linear(name, cin, cout):
            out.extend([(f"{name}.weight", (cout, cin), "head_weight"),
                        (f"{name}.bias", (cout,), "bias")])

        def conv(name, cin, cout, k, groups=1):
            out.extend([(f"{name}.weight", (cout, cin // groups, k, k), "conv"),
                        (f"{name}.bias", (cout,), "bias")])

        cin = self.n_channels
        for i, (c, r, sr, depth) in enumerate(zip(self.dims, self.ratios, self.sr, self.depths)):
            s = i + 1
            conv(f"backbone.patch_embed{s}.proj", cin, c, 7 if i == 0 else 3)
            norm(f"backbone.patch_embed{s}.norm", c)
            for j in range(depth):
                b = f"backbone.block{s}.{j}"
                norm(f"{b}.norm1", c)
                linear(f"{b}.attn.q", c, c)
                linear(f"{b}.attn.kv", c, 2 * c)
                if sr > 1:
                    conv(f"{b}.attn.sr", c, c, sr)
                    norm(f"{b}.attn.norm", c)
                linear(f"{b}.attn.proj", c, c)
                norm(f"{b}.norm2", c)
                linear(f"{b}.mlp.fc1", c, r * c)
                conv(f"{b}.mlp.dwconv.dwconv", r * c, r * c, 3, groups=r * c)
                linear(f"{b}.mlp.fc2", r * c, c)
            norm(f"backbone.norm{s}", c)
            cin = c
        e = self.embed
        for i, c in enumerate(self.dims):
            linear(f"decode_head.linear_c{i + 1}.proj", c, e)
        out.append(("decode_head.linear_fuse.conv.weight", (e, len(self.dims) * e, 1, 1),
                    "head_weight"))
        norm("decode_head.linear_fuse.bn", e)
        out.extend([("decode_head.linear_fuse.bn.running_mean", (e,), "running_mean"),
                    ("decode_head.linear_fuse.bn.running_var", (e,), "running_var"),
                    ("decode_head.linear_fuse.bn.num_batches_tracked", (), "count"),
                    ("decode_head.linear_pred.weight", (self.n_classes, e, 1, 1), "head_weight"),
                    ("decode_head.linear_pred.bias", (self.n_classes,), "bias")])
        return out

    def forward(self, p: Dict[str, torch.Tensor], x: torch.Tensor, *, bn: str = "eval",
                keep: Optional[Sequence[torch.Tensor]] = None,
                lowp: Callable[[torch.Tensor], torch.Tensor] = _same):
        """The logits (a 1-tuple, NCHW, the input's size) and, under
        ``bn='train'``, the moved BatchNorm running statistics by name.
        ``bn``: 'train' (batch statistics; stochastic depth and dropout under
        ``keep``, the masks in the order above) or 'eval'. ``lowp`` rounds
        every conv's and linear's input, weight and output and both
        attention products' operands and outputs (the control's lower
        precision, where the program computes in bf16)."""
        h, w = x.shape[2:]
        if (h, w) != (self.h, self.w):
            raise ValueError(f"the reference is built for {self.h}x{self.w}, got {h}x{w}")
        train = bn == "train"
        n_masks = self.n_masks()
        if train and n_masks and keep is None:
            raise ValueError("train mode takes the stochastic-depth and dropout keep masks")
        masks = iter(list(keep) if train and n_masks else [])
        stats: Dict[str, torch.Tensor] = {}
        run = (lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)) \
            if torch.is_grad_enabled() else (lambda fn, *a: fn(*a))

        def conv2d(t, name, stride=1, padding=0, groups=1, bias=True):
            return lowp(F.conv2d(lowp(t), lowp(p[f"{name}.weight"]),
                                 p[f"{name}.bias"] if bias else None, stride, padding, 1, groups))

        def linear(t, name):
            return lowp(F.linear(lowp(t), lowp(p[f"{name}.weight"]), p[f"{name}.bias"]))

        def layer_norm(t, name, eps):
            return F.layer_norm(t, (t.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], eps)

        def to_tokens(m):
            return m.flatten(2).transpose(1, 2)

        def to_map(t, hh, ww):
            return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], hh, ww)

        def drop(t, k, rate):
            return t if k is None else t * (k.to(t.dtype) / (1.0 - rate)).view(-1, 1, 1)

        def block(t, b, c, heads, sr, hh, ww, rate, k1, k2):
            n, length, _ = t.shape
            y = layer_norm(t, f"{b}.norm1", LN_EPS)
            q = linear(y, f"{b}.attn.q")
            if sr > 1:
                r = conv2d(to_map(y, hh, ww), f"{b}.attn.sr", stride=sr)
                r = layer_norm(to_tokens(r), f"{b}.attn.norm", EMBED_LN_EPS)
            else:
                r = y
            kv = linear(r, f"{b}.attn.kv")
            d = c // heads

            def split(z):
                return z.reshape(n, z.shape[1], heads, d).transpose(1, 2)

            q, k, v = split(q), split(kv[..., :c]), split(kv[..., c:])
            scores = lowp(lowp(q) @ lowp(k).transpose(-1, -2)) / d ** 0.5
            o = lowp(lowp(torch.softmax(scores, dim=-1)) @ lowp(v))
            t = t + drop(linear(o.transpose(1, 2).reshape(n, length, c), f"{b}.attn.proj"), k1,
                         rate)
            y = linear(layer_norm(t, f"{b}.norm2", LN_EPS), f"{b}.mlp.fc1")
            y = conv2d(to_map(y, hh, ww), f"{b}.mlp.dwconv.dwconv", padding=1,
                       groups=y.shape[2])
            y = linear(F.gelu(to_tokens(y)), f"{b}.mlp.fc2")
            return t + drop(y, k2, rate)

        def head(k, *feats):
            e = self.embed
            size = feats[0].shape[2:]
            maps = []
            for i, f in enumerate(feats):
                m = to_map(linear(to_tokens(f), f"decode_head.linear_c{i + 1}.proj"),
                           *f.shape[2:])
                if i:
                    m = F.interpolate(m, size=size, mode="bilinear", align_corners=False)
                maps.append(m)
            y = conv2d(torch.cat(maps[::-1], dim=1), "decode_head.linear_fuse.conv", bias=False)
            y = F.relu(_batch_norm(p, "decode_head.linear_fuse.bn", y, train, stats))
            if k is not None:
                y = y * (k.to(y.dtype) / (1.0 - self.dropout)).view(-1, e, 1, 1)
            y = conv2d(y, "decode_head.linear_pred")
            return F.interpolate(y, size=(h, w), mode="bilinear", align_corners=False)

        feats, y, j = [], x, 0
        for i, (c, heads, sr, depth) in enumerate(zip(self.dims, self.heads, self.sr,
                                                      self.depths)):
            s = i + 1
            k = 7 if i == 0 else 3
            y = conv2d(y, f"backbone.patch_embed{s}.proj", stride=4 if i == 0 else 2,
                       padding=k // 2)
            hh, ww = y.shape[2:]
            t = layer_norm(to_tokens(y), f"backbone.patch_embed{s}.norm", EMBED_LN_EPS)
            for b in range(depth):
                rate = self.rates[j]
                k1, k2 = (next(masks), next(masks)) if train and n_masks and rate > 0 \
                    else (None, None)
                t = run(block, t, f"backbone.block{s}.{b}", c, heads, sr, hh, ww, rate, k1, k2)
                j += 1
            t = layer_norm(t, f"backbone.norm{s}", LN_EPS)
            y = to_map(t, hh, ww)
            feats.append(y)
        k = next(masks, None) if train and self.dropout > 0 else None
        return (run(head, k, *feats),), stats


def build(config: Dict) -> SegFormerRef:
    """The reference model of a configuration that names this module."""
    return SegFormerRef(config)
