"""TransUNet, R50-ViT-B/16 hybrid (Chen et al., arXiv:2102.04306; the public
code's ``networks/vit_seg_modeling.py``, ``vit_seg_modeling_resnet_skip.py``
and ``vit_seg_configs.py::get_r50_b16_config``), for the segmentation train
step.

Tensors are NCHW (channels_last in memory on the GPU); tokens are (N, T, D).

- **Hybrid encoder** (``transformer.embeddings.hybrid_model``): ResNet-50 v2
  as BiT builds it, its first three stages. Every conv is a
  :class:`StdConv2d` (bias off), whose weight is standardised on every
  call, ``(W - mean) / sqrt(var + 1e-5)`` over (in, kh, kw). Root:
  ``relu(GN32(conv7x7/2(x)))``, then a 3x3/2 max-pool without padding.
  Stages of ``resnet_units`` bottleneck units (mid width ``cout / 4``),
  ``relu(r + GN(conv1x1(relu(GN(conv3x3/s(relu(GN(conv1x1(x)))))))))``,
  the residual ``r`` being ``x`` or, in a stage's first unit,
  ``GN(cout groups, eps 1e-5)(conv1x1/s(x))``; GroupNorm eps 1e-6
  elsewhere. The skips are the root's output (H/2), stage 1's (H/4) and
  stage 2's (H/8). The max-pool leaves stage 1 a row and a column short;
  its skip is zero-padded at the bottom and right to H/4 and W/4 each (the
  public code pads both sides to the input's H/4 and assumes a square
  image).
- **Embedding**: a biased 1x1 conv to ``hidden_size`` over the H/16 x W/16 grid,
  a learned position table of one row per token, dropout.
- **Encoder**: ``num_layers`` pre-LN blocks (LayerNorm eps 1e-6),
  ``x + out(attention(LN(x)))`` with ``num_heads`` heads,
  ``softmax(QK^T / sqrt(d))V``, and ``x + drop(fc2(drop(gelu(fc1(LN(x))))))``
  (erf GELU), then a final LayerNorm.
- **Decoder**: the tokens as a (hidden_size, H/16, W/16) map, ``conv_more`` (a
  3x3 conv, BatchNorm, ReLU, to 512), then four blocks, each a 2x bilinear
  upsample (align corners), the skip concatenated after it, and two 3x3
  conv-BN-ReLU; the head is a biased 3x3 conv to the classes.

Precision follows the policy: convs, linears and the attention core run in
the compute dtype (float32 parameters cast at use); the weight
standardisation, GroupNorm, LayerNorm, BatchNorm and the residual stream of
the encoder are float32. The hybrid ResNet runs in the NCHW layout (its
standardised weights too), which CUDA's GroupNorm takes without a copy.
BatchNorm is ``models/blocks.py``'s, through
:func:`~tpu_unet_torch.models.blocks.conv_bn`, as in the ladders.

The attention core is ``ops/attention.py::attention_core``, which SegFormer
shares: ``F.scaled_dot_product_attention`` on the fused backends alone on
CUDA.

Dropout is a draw: in train mode ``forward(x, keep)`` takes the tuple of
boolean keep masks that :meth:`TransUNet.sample_dropout` draws, the
embedding's (N, T, hidden_size) and each block's two, after the GELU (N, T,
mlp_dim) and after fc2 (N, T, hidden_size), and applies each as ``x * keep / (1 -
rate)``. Attention dropout is 0, as published.

The forward runs in spans (``utils/spans.py``): ``transunet.hybrid``,
``transunet.embed``, ``transunet.encoder`` (each block's core alone in
``transunet.attention``, from Q, K and V in head layout to the heads'
output) and ``transunet.decoder``. :data:`COUNTERS` counts the attention
core's calls and the query tokens they attended.

Training is the model's only path: BN folding, int8, the seg serving
engine, the 'space' axis and tensor parallelism refuse a TransUNet
(``train_only``, read by ``models/blocks.py::refuse_train_only``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_unet_torch.core.precision import DEFAULT_POLICY, Policy
from tpu_unet_torch.models.blocks import BatchNorm2d, conv_bn
from tpu_unet_torch.ops.attention import attention_core
from tpu_unet_torch.ops.resize import upsample2x_bilinear_align_corners
from tpu_unet_torch.utils.spans import span

COUNTERS = {"attention_calls": 0, "attention_tokens": 0}

STD_EPS = 1e-5
GN_GROUPS = 32
GN_EPS = 1e-6
LN_EPS = 1e-6
CONV_MORE = 512  # the decoder's first width, the public code's head_channels


class StdConv2d(nn.Conv2d):
    """A bias-free conv whose weight is standardised per output channel on
    every call, in float32; the conv runs in the policy's compute dtype."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, policy: Policy = DEFAULT_POLICY):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.policy = policy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (self.weight - mean) / torch.sqrt(var + STD_EPS)
        cd = self.policy.compute_dtype
        return F.conv2d(x.to(cd), w.to(cd).contiguous(), None, self.stride, self.padding)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` computed in float32, whatever the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.to(torch.float32), self.num_groups, self.weight, self.bias,
                            self.eps)


class PreActBottleneck(nn.Module):
    """One unit of the hybrid ResNet (module docstring); the public code's
    names (``conv1``..``conv3``, ``gn1``..``gn3``, ``downsample``,
    ``gn_proj``)."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int, policy: Policy):
        super().__init__()
        self.policy = policy
        self.gn1 = GroupNorm(GN_GROUPS, cmid, eps=GN_EPS)
        self.conv1 = StdConv2d(cin, cmid, 1, policy=policy)
        self.gn2 = GroupNorm(GN_GROUPS, cmid, eps=GN_EPS)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride=stride, padding=1, policy=policy)
        self.gn3 = GroupNorm(GN_GROUPS, cout, eps=GN_EPS)
        self.conv3 = StdConv2d(cmid, cout, 1, policy=policy)
        if stride != 1 or cin != cout:
            self.downsample = StdConv2d(cin, cout, 1, stride=stride, policy=policy)
            self.gn_proj = GroupNorm(cout, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        r = self.gn_proj(self.downsample(x)) if hasattr(self, "downsample") else x
        y = F.relu(self.gn1(self.conv1(x))).to(cd)
        y = F.relu(self.gn2(self.conv2(y))).to(cd)
        return F.relu(r + self.gn3(self.conv3(y))).to(cd)


class ResNetV2(nn.Module):
    """The hybrid encoder: root and ``len(units)`` stages of width
    ``4 w, 8 w, 16 w``. ``forward`` returns the last stage's output and the
    skips, deepest first."""

    def __init__(self, n_channels: int, width: int, units: Sequence[int], policy: Policy):
        super().__init__()
        self.policy = policy
        self.root = nn.Sequential(OrderedDict([
            ("conv", StdConv2d(n_channels, width, 7, stride=2, padding=3, policy=policy)),
            ("gn", GroupNorm(GN_GROUPS, width, eps=GN_EPS)),
            ("relu", nn.ReLU(inplace=True))]))
        stages, cin = [], width
        for s, n in enumerate(units):
            cout = width * 4 << s
            stages.append((f"block{s + 1}", nn.Sequential(OrderedDict(
                (f"unit{u + 1}", PreActBottleneck(cin if u == 0 else cout, cout, cout // 4,
                                                  2 if s > 0 and u == 0 else 1, policy))
                for u in range(n)))))
            cin = cout
        self.body = nn.Sequential(OrderedDict(stages))
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, list]:
        h, w = x.shape[2:]
        x = x.contiguous()  # NCHW throughout: CUDA's GroupNorm takes no other layout
        root = self.root
        x = F.relu(root.gn(root.conv(x))).to(self.policy.compute_dtype)
        skips = [x]
        x = F.max_pool2d(x, 3, 2)
        for s, stage in enumerate(self.body[:-1]):
            x = stage(x)
            hh, ww = h // (4 << s), w // (4 << s)
            skips.append(F.pad(x, (0, ww - x.shape[3], 0, hh - x.shape[2])))
        return self.body[-1](x), skips[::-1]


class Embeddings(nn.Module):
    """The hybrid encoder, the 1x1 patch embedding and the position table."""

    def __init__(self, n_channels: int, width: int, units: Sequence[int], hidden: int,
                 n_tokens: int, policy: Policy):
        super().__init__()
        self.policy = policy
        self.hybrid_model = ResNetV2(n_channels, width, units, policy)
        self.patch_embeddings = nn.Conv2d(self.hybrid_model.out_channels, hidden, 1)
        self.position_embeddings = nn.Parameter(torch.zeros(1, n_tokens, hidden))


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp)
        self.fc2 = nn.Linear(mlp, hidden)
        for fc in (self.fc1, self.fc2):  # the public code's initialisation
            nn.init.xavier_uniform_(fc.weight)
            nn.init.normal_(fc.bias, std=1e-6)


class Block(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp: int):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.attn = Attention(hidden, heads)
        self.ffn_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.ffn = Mlp(hidden, mlp)


class Encoder(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp: int, layers: int):
        super().__init__()
        self.layer = nn.ModuleList(Block(hidden, heads, mlp) for _ in range(layers))
        self.encoder_norm = nn.LayerNorm(hidden, eps=LN_EPS)


class Transformer(nn.Module):
    def __init__(self, embeddings: Embeddings, encoder: Encoder):
        super().__init__()
        self.embeddings = embeddings
        self.encoder = encoder


class Conv2dReLU(nn.Sequential):
    """3x3 conv (no bias), BatchNorm, ReLU: the public code's ``Conv2dReLU``
    (children ``0``, ``1``, ``2``)."""

    def __init__(self, cin: int, cout: int, policy: Policy):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=1, bias=False), BatchNorm2d(cout),
                         nn.ReLU(inplace=True))
        self.policy = policy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn(self[0], self[1], x, self.policy, padding=1)
        return F.relu(y).to(self.policy.compute_dtype)


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int, policy: Policy):
        super().__init__()
        self.conv1 = Conv2dReLU(cin + skip, cout, policy)
        self.conv2 = Conv2dReLU(cout, cout, policy)


class DecoderCup(nn.Module):
    def __init__(self, hidden: int, channels: Sequence[int], skips: Sequence[int],
                 policy: Policy):
        super().__init__()
        self.conv_more = Conv2dReLU(hidden, CONV_MORE, policy)
        ins = [CONV_MORE, *channels[:-1]]
        self.blocks = nn.ModuleList(DecoderBlock(i, o, s, policy)
                                    for i, o, s in zip(ins, channels, skips))


class TransUNet(nn.Module):
    """TransUNet at the published R50-ViT-B/16 widths by default (module
    docstring). ``image_size_hw`` sets the position table's length, one
    row per 16x16 pixels; both sides must be multiples of 16. ``width``
    and ``resnet_units`` shape the hybrid ResNet (GroupNorm of 32 groups);
    ``hidden_size``, ``num_layers``, ``num_heads`` and ``mlp_dim`` the
    encoder (the public config's names); ``decoder_channels`` the decoder
    blocks' widths. The first three blocks take the skips, stage 2's (8 w),
    stage 1's (4 w) and the root's (w), as the public config's three skips
    do."""

    train_only = True

    def __init__(self, image_size_hw: Tuple[int, int], n_channels: int = 3,
                 n_classes: int = 9, dropout: float = 0.1, policy: Policy = DEFAULT_POLICY,
                 width: int = 64, resnet_units: Sequence[int] = (3, 4, 9),
                 hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, decoder_channels: Sequence[int] = (256, 128, 64, 16)):
        super().__init__()
        h, w = (int(s) for s in image_size_hw)
        if h % 16 or w % 16:
            raise ValueError(f"TransUNet takes sizes divisible by 16, got {h}x{w}")
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple of num_heads "
                             f"{num_heads}")
        if len(resnet_units) != 3:
            raise ValueError(f"the hybrid ResNet has three stages, got {tuple(resnet_units)}")
        self.policy, self.dropout = policy, float(dropout)
        self.grid = (h // 16, w // 16)
        self.hidden, self.mlp, self.n_layers = hidden_size, mlp_dim, num_layers
        self.transformer = Transformer(
            Embeddings(n_channels, width, resnet_units, hidden_size,
                       self.grid[0] * self.grid[1], policy),
            Encoder(hidden_size, num_heads, mlp_dim, num_layers))
        self.decoder = DecoderCup(hidden_size, decoder_channels,
                                  (8 * width, 4 * width, width, 0), policy)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder_channels[-1], n_classes, 3, padding=1), nn.Identity())

    def keep_shapes(self, n: int) -> list:
        """The shapes of the keep masks of a batch of ``n``, in order: the
        embedding's, then fc1's and fc2's of each block."""
        t = self.grid[0] * self.grid[1]
        return [(n, t, self.hidden)] + [(n, t, c) for _ in range(self.n_layers)
                                        for c in (self.mlp, self.hidden)]

    def sample_dropout(self, n: int, generator: torch.Generator
                       ) -> Optional[Tuple[torch.Tensor, ...]]:
        """The keep masks of a batch of ``n`` on the generator's device (None
        without dropout): one uint8 draw an element, uniform over 0..99,
        kept at or above ``100 x rate``; the masks are views of it."""
        if self.dropout <= 0:
            return None
        q = round(100 * self.dropout)
        if abs(q - 100 * self.dropout) > 1e-9:
            raise ValueError(f"the dropout draw takes rates in steps of 0.01, got {self.dropout}")
        shapes = self.keep_shapes(n)
        n, t = shapes[0][:2]
        u = torch.randint(0, 100, (n, t, sum(s[2] for s in shapes)), dtype=torch.uint8,
                          generator=generator, device=generator.device)
        packed = u.ge_(q).view(torch.bool)
        out, offset = [], 0
        for s in shapes:
            out.append(packed[..., offset:offset + s[2]])
            offset += s[2]
        return tuple(out)

    def _check_keep(self, keep, n: int) -> None:
        shapes = self.keep_shapes(n)
        if keep is None:
            raise ValueError("TransUNet in train mode takes its dropout draw: "
                             "forward(x, keep=model.sample_dropout(n, generator))")
        got = [tuple(k.shape) for k in keep]
        if got != shapes:
            raise ValueError(f"TransUNet keep masks {got}, expected {shapes}")

    def _drop(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        """``x * keep / (1 - rate)``; the select keeps one dtype a kernel."""
        return x if keep is None else torch.where(keep, x, 0.0) / (1.0 - self.dropout)

    def forward(self, x: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        cd = self.policy.compute_dtype
        n = x.shape[0]
        if self.training and self.dropout > 0:
            self._check_keep(keep, n)
            keep = [k.to(x.device) for k in keep]
        else:
            keep = [None] * (1 + 2 * self.n_layers)
        emb = self.transformer.embeddings
        with span("transunet.hybrid"):
            feat, skips = emb.hybrid_model(x.to(cd))
        with span("transunet.embed"):
            pe = emb.patch_embeddings
            y = F.conv2d(feat, pe.weight.to(cd), pe.bias.to(cd))
            t = y.permute(0, 2, 3, 1).reshape(n, -1, self.hidden)
            t = self._drop(t + emb.position_embeddings, keep[0])
        with span("transunet.encoder"):
            for i, block in enumerate(self.transformer.encoder.layer):
                t = self._block(block, t, keep[1 + 2 * i], keep[2 + 2 * i])
            enc = self.transformer.encoder.encoder_norm
            t = F.layer_norm(t, (self.hidden,), enc.weight, enc.bias, enc.eps).to(cd)
        with span("transunet.decoder"):
            dec = self.decoder
            y = dec.conv_more(t.reshape(n, *self.grid, self.hidden).permute(0, 3, 1, 2))
            for i, block in enumerate(dec.blocks):
                y = upsample2x_bilinear_align_corners(y)
                if i < len(skips):
                    y = torch.cat([y, skips[i]], dim=1)
                y = block.conv2(block.conv1(y))
            head = self.segmentation_head[0]
            y = F.conv2d(y, head.weight.to(cd), head.bias.to(cd), padding=1)
        return self.policy.cast_to_output(y)

    def _block(self, block: Block, t: torch.Tensor, keep1, keep2) -> torch.Tensor:
        """One pre-LN block on the float32 residual stream ``t``."""
        cd = self.policy.compute_dtype
        n, tokens, d = t.shape
        a, ln = block.attn, block.attention_norm
        y = F.layer_norm(t, (d,), ln.weight, ln.bias, ln.eps).to(cd)
        w = torch.cat([a.query.weight, a.key.weight, a.value.weight]).to(cd)
        b = torch.cat([a.query.bias, a.key.bias, a.value.bias]).to(cd)
        q, k, v = F.linear(y, w, b).view(n, tokens, 3, a.heads, d // a.heads).permute(
            2, 0, 3, 1, 4)
        with span("transunet.attention"):
            o = attention_core(q, k, v)
        COUNTERS["attention_calls"] += 1
        COUNTERS["attention_tokens"] += n * tokens
        o = o.transpose(1, 2).reshape(n, tokens, d)
        t = t + F.linear(o, a.out.weight.to(cd), a.out.bias.to(cd))
        ln, f = block.ffn_norm, block.ffn
        y = F.layer_norm(t, (d,), ln.weight, ln.bias, ln.eps).to(cd)
        y = self._drop(F.gelu(F.linear(y, f.fc1.weight.to(cd), f.fc1.bias.to(cd))), keep1)
        y = self._drop(F.linear(y, f.fc2.weight.to(cd), f.fc2.bias.to(cd)), keep2)
        return t + y
