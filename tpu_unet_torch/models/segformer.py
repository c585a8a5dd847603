"""SegFormer, a MiT encoder and the all-MLP head (Xie et al., arXiv:2105.15203;
the public code's ``mmseg/models/backbones/mix_transformer.py::mit_b5`` and
``mmseg/models/decode_heads/segformer_head.py``), for the segmentation train
step. MiT-B5 and a 768 head by default.

Tensors are NCHW (channels_last in memory on the GPU); tokens are (N, T, C),
T = H W in row-major order. A channels_last (N, C, H, W) map is an (N, T, C)
token tensor in memory, so the token <-> map transitions are views
(:func:`tokens`, :func:`as_map`); on the CPU a contiguous map's tokens are
a copy.

- **Encoder** (``backbone``): four stages i of width ``embed_dims[i]``.
  - Overlapping patch embedding (``patch_embed{i}``): a biased conv k x k,
    stride s, padding k // 2 (stage 1 k 7, s 4; then k 3, s 2), the map as
    tokens, LayerNorm (eps 1e-5).
  - ``depths[i]`` pre-LN blocks (``block{i}.{j}``, LayerNorm eps 1e-6):
    ``x + dp(attn(LN1(x)))`` then ``x + dp(mlp(LN2(x)))``.
  - Efficient self-attention (``attn``): ``q = Linear(C, C)(x)``; where the
    stage's ratio R > 1 the keys and values come from a reduced map,
    ``LN(eps 1e-5)(Conv2d(C, C, R, stride R)(x as a map))`` as tokens
    (``sr``, ``norm``), else from ``x``; ``kv = Linear(C, 2C)``, K the first C
    outputs and V the next; ``num_heads[i]`` heads; the core is
    ``ops/attention.py::attention_core``; then ``proj``.
  - Mix-FFN (``mlp``): ``fc2(gelu_erf(dwconv3x3(fc1(x))))``, fc1 to
    ``mlp_ratios[i]`` C, the depthwise conv (``dwconv.dwconv``, biased,
    padding 1) on the tokens as a map.
  - Stochastic depth (``dp``, timm's DropPath): block j of all of them,
    counted from 0, has the rate ``linspace(0, drop_path_rate, sum(depths))[j]``;
    each of its two branches is multiplied by its own per-sample keep, an
    (N,) mask, over ``1 - rate``. A block of rate 0 draws nothing.
  - After each stage a LayerNorm (``norm{i}``, eps 1e-6), and the tokens as
    the stage's map, which the next stage embeds.
- **Head** (``decode_head``, embedding ``embedding_dim``): per stage a
  ``Linear(C_i, E)`` over its tokens (``linear_c{i}.proj``) as a map; stages
  2-4 upsampled bilinearly, half-pixel (``ops/resize.py::
  upsample_bilinear_half_pixel``), to stage 1's size; concatenated as [c4,
  c3, c2, c1]; ``linear_fuse`` (a bias-free 1x1 conv to E, BatchNorm, ReLU,
  through ``models/blocks.py::conv_bn``); Dropout2d under an (N, E) keep
  mask; ``linear_pred``, a biased 1x1 conv to the classes; the logits
  upsampled half-pixel to the input's size (mmseg resizes them to the label
  before the loss).

Precision follows the policy: convs, linears and the attention core run in
the compute dtype (float32 parameters cast at use); LayerNorm, BatchNorm and
the encoder's residual stream are float32, as in TransUNet; the logits'
resize runs in float32.

Dropout is a draw: in train mode ``forward(x, keep)`` takes the tuple of
boolean keep masks that :meth:`SegFormer.sample_dropout` draws, in order the
two (N,) branch masks of each block of nonzero rate, then the head's (N, E)
(:meth:`SegFormer.keep_shapes`).

The forward runs in spans (``utils/spans.py``): ``segformer.encoder``, which
holds each block's ``segformer.attention`` (the core alone, from q, k and v in
head layout to the heads' output) and ``segformer.dwconv`` (the depthwise
conv with its views), and ``segformer.decoder``. :data:`COUNTERS` counts the
attention core's calls and the query and key tokens they took.

On CUDA a training forward inside the train step's
``models/blocks.py::graph_replay`` (the step's first microbatch, on one
device, nothing recomputed) replays each stage's blocks as one CUDA graph,
forward and back (``torch.cuda.make_graphed_callables``, captured at the
first such forward of a shape). Eager, the 52 blocks' short operations cost
the host more than the card (some 4,500 launches a step at b16 1024x512);
graphed, the card sets the pace, and the stream passes from block to block
inside a graph, with no copy into the next graph's placeholder. A replay
runs no Python: the attention and dwconv spans are the eager forward's
alone, and :data:`COUNTERS` counts in the stage loop. Every other forward
(the CPU, eval, a microbatch that accumulates into gradients already held,
a data group) runs the blocks eagerly.

Training is the model's only path: BN folding, int8, the seg serving engine,
the 'space' axis and tensor parallelism refuse a SegFormer (``train_only``,
read by ``models/blocks.py::refuse_train_only``).
"""

from __future__ import annotations

import gc
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from tpu_unet_torch.core.precision import DEFAULT_POLICY, Policy
from tpu_unet_torch.models.blocks import BatchNorm2d, conv_bn, replaying_graphs
from tpu_unet_torch.ops.attention import attention_core
from tpu_unet_torch.ops.resize import upsample_bilinear_half_pixel
from tpu_unet_torch.utils.spans import span

COUNTERS = {"attention_calls": 0, "query_tokens": 0, "key_tokens": 0}

EMBED_LN_EPS = 1e-5  # the patch embeddings' and the reduction's LayerNorm
LN_EPS = 1e-6        # the blocks' and the stages' LayerNorm


def tokens(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H W, C); a view of a channels_last map."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


def as_map(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H W, C) -> (N, C, H, W), channels_last in memory: a view."""
    n, _, c = t.shape
    return t.view(n, h, w, c).permute(0, 3, 1, 2)


def drop_path_rates(depths: Sequence[int], rate: float) -> List[float]:
    """Each block's stochastic-depth rate, in order over the stages:
    ``torch.linspace(0, rate, sum(depths))`` (float32, as timm draws it)."""
    return torch.linspace(0, rate, sum(depths), device="cpu").tolist()


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.stride = stride
        self.proj = nn.Conv2d(cin, cout, kernel, stride, kernel // 2)
        self.norm = nn.LayerNorm(cout, eps=EMBED_LN_EPS)


class Attention(nn.Module):
    """mmseg's efficient self-attention: ``q``, ``kv``, ``proj`` and, where
    ``sr_ratio`` > 1, the reduction ``sr`` and its ``norm``."""

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=EMBED_LN_EPS)


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)


class Mlp(nn.Module):
    """Mix-FFN: ``fc1``, ``dwconv.dwconv``, ``fc2``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, sr_ratio: int, rate: float):
        super().__init__()
        self.rate = rate
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, t: torch.Tensor, scales: Tuple = (), *, h: int, w: int,
                cd: torch.dtype) -> torch.Tensor:
        """The block on the float32 residual stream ``t`` of an h x w map:
        LN1, q, the reduction and kv, the attention core (q, k and v in head
        layout, (N, heads, T or M, 64)), proj into the stream, LN2, fc1, the
        depthwise conv, GELU, fc2 into the stream; ``scales`` the branches'
        (N, 1, 1) stochastic-depth scales, or empty."""
        n, length, c = t.shape
        a = self.attn
        y = F.layer_norm(t, (c,), self.norm1.weight, self.norm1.bias, self.norm1.eps).to(cd)
        q = _linear(y, a.q, cd)
        if a.sr_ratio > 1:
            r = F.conv2d(as_map(y, h, w), a.sr.weight.to(cd), a.sr.bias.to(cd), a.sr_ratio)
            r = F.layer_norm(tokens(r).float(), (c,), a.norm.weight, a.norm.bias,
                             a.norm.eps).to(cd)
        else:
            r = y
        d = c // a.heads
        k, v = _linear(r, a.kv, cd).view(n, r.shape[1], 2, a.heads, d).unbind(2)
        with span("segformer.attention"):
            o = attention_core(q.view(n, length, a.heads, d).transpose(1, 2),
                               k.transpose(1, 2), v.transpose(1, 2))
        t = _residual(t, _linear(o.transpose(1, 2).reshape(n, length, c), a.proj, cd),
                      scales[:1])
        y = F.layer_norm(t, (c,), self.norm2.weight, self.norm2.bias, self.norm2.eps).to(cd)
        y = _linear(y, self.mlp.fc1, cd)
        with span("segformer.dwconv"):
            dw = self.mlp.dwconv.dwconv
            y = tokens(F.conv2d(as_map(y, h, w), dw.weight.to(cd), dw.bias.to(cd), padding=1,
                                groups=y.shape[2]))
        return _residual(t, _linear(F.gelu(y), self.mlp.fc2, cd), scales[1:])

    def count(self, n: int, h: int, w: int) -> None:
        """Adds one forward of this block on an n x h x w map to
        :data:`COUNTERS` (a graph's replay runs no Python)."""
        r = self.attn.sr_ratio
        COUNTERS["attention_calls"] += 1
        COUNTERS["query_tokens"] += n * h * w
        COUNTERS["key_tokens"] += n * ((h // r) * (w // r) if r > 1 else h * w)


class MixVisionTransformer(nn.Module):
    """The encoder's modules under mmseg's names (``patch_embed{i}``,
    ``block{i}``, ``norm{i}``, i from 1)."""

    def __init__(self, n_channels: int, embed_dims: Sequence[int], num_heads: Sequence[int],
                 mlp_ratios: Sequence[int], depths: Sequence[int], sr_ratios: Sequence[int],
                 drop_path_rate: float):
        super().__init__()
        rates = drop_path_rates(depths, drop_path_rate)
        cin, j = n_channels, 0
        for i, (c, heads, ratio, depth, sr) in enumerate(
                zip(embed_dims, num_heads, mlp_ratios, depths, sr_ratios)):
            k, s = (7, 4) if i == 0 else (3, 2)
            setattr(self, f"patch_embed{i + 1}", OverlapPatchEmbed(cin, c, k, s))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                Block(c, heads, ratio, sr, rates[j + b]) for b in range(depth)))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(c, eps=LN_EPS))
            cin, j = c, j + depth
        self.n_stages = len(embed_dims)

    def stages(self):
        """(patch embedding, blocks, norm) of each stage, in order."""
        return [(getattr(self, f"patch_embed{i + 1}"), getattr(self, f"block{i + 1}"),
                 getattr(self, f"norm{i + 1}")) for i in range(self.n_stages)]


class LinearMLP(nn.Module):
    """The head's per-stage ``Linear(C_i, E)``, named ``proj``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)


class ConvModule(nn.Module):
    """mmcv's ConvModule as ``linear_fuse`` uses it: ``conv`` (1x1, no bias),
    ``bn``, ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = BatchNorm2d(cout)


class SegFormerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], embedding_dim: int, n_classes: int):
        super().__init__()
        for i, c in enumerate(in_channels):
            setattr(self, f"linear_c{i + 1}", LinearMLP(c, embedding_dim))
        self.linear_fuse = ConvModule(len(in_channels) * embedding_dim, embedding_dim)
        self.linear_pred = nn.Conv2d(embedding_dim, n_classes, 1)


class SegFormer(nn.Module):
    """SegFormer at MiT-B5 and a 768 head by default (module docstring).
    ``embed_dims``, ``num_heads``, ``mlp_ratios``, ``depths``, ``sr_ratios``
    and ``drop_path_rate`` are mmseg's MixVisionTransformer's keywords;
    ``embedding_dim`` the head's; ``dropout`` the head's Dropout2d rate. The
    input's sides must be multiples of 32 (stride 4, then 2, 2, 2)."""

    train_only = True

    def __init__(self, n_channels: int = 3, n_classes: int = 150, dropout: float = 0.1,
                 policy: Policy = DEFAULT_POLICY,
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 mlp_ratios: Sequence[int] = (4, 4, 4, 4),
                 depths: Sequence[int] = (3, 6, 40, 3),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 drop_path_rate: float = 0.1, embedding_dim: int = 768):
        super().__init__()
        widths = [tuple(embed_dims), tuple(num_heads), tuple(mlp_ratios), tuple(depths),
                  tuple(sr_ratios)]
        if len({len(v) for v in widths}) != 1:
            raise ValueError(f"SegFormer's stage widths differ in length: {widths}")
        for c, heads in zip(embed_dims, num_heads):
            if c % heads:
                raise ValueError(f"a stage of width {c} does not split into {heads} heads")
        self.policy, self.dropout = policy, float(dropout)
        self.embedding_dim = embedding_dim
        self.backbone = MixVisionTransformer(n_channels, embed_dims, num_heads, mlp_ratios,
                                             depths, sr_ratios, float(drop_path_rate))
        self.decode_head = SegFormerHead(embed_dims, embedding_dim, n_classes)
        self.blocks = [b for _, blocks, _ in self.backbone.stages() for b in blocks]
        self._constants = {}  # small float32 tensors by (name, device): _constant
        self._graphs = None  # the stages' graphs, with their parameters: _graphed_stages
        self._graph_key = None  # the input shape and parameter memory they were captured on

    def keep_shapes(self, n: int) -> list:
        """The shapes of the keep masks of a batch of ``n``, in order: two
        (n,) of each block of nonzero rate, then the head's (n, E) where the
        head's dropout is nonzero."""
        return [(n,) for b in self.blocks if b.rate > 0 for _ in range(2)] + \
            ([(n, self.embedding_dim)] if self.dropout > 0 else [])

    def _rates(self) -> List[float]:
        """Each column's rate in the packed draw of :meth:`sample_dropout`."""
        return [b.rate for b in self.blocks if b.rate > 0 for _ in range(2)] + \
            [self.dropout] * (self.embedding_dim if self.dropout > 0 else 0)

    def _constant(self, name: str, values: List[float], device) -> torch.Tensor:
        """``values`` as a float32 tensor on ``device``, made once per device:
        a copy from the host inside a step would wait for the device to
        drain."""
        key = (name, torch.device(device))
        if key not in self._constants:
            self._constants[key] = torch.tensor(values, dtype=torch.float32, device=device)
        return self._constants[key]

    def sample_dropout(self, n: int, generator: torch.Generator
                       ) -> Optional[Tuple[torch.Tensor, ...]]:
        """The keep masks of a batch of ``n`` on the generator's device (None
        without any dropout): one float32 uniform draw of (n, columns), a
        column kept where the draw is at or above its rate; the masks are
        views of it."""
        rates = self._rates()
        if not rates:
            return None
        dev = generator.device
        u = torch.rand((n, len(rates)), generator=generator, device=dev)
        packed = u >= self._constant("rates", rates, dev)
        branches = len(rates) - (self.embedding_dim if self.dropout > 0 else 0)
        head = (packed[:, branches:],) if self.dropout > 0 else ()
        return tuple(packed[:, :branches].unbind(1)) + head

    def _check_keep(self, keep, n: int) -> None:
        shapes = self.keep_shapes(n)
        if keep is None:
            raise ValueError("SegFormer in train mode takes its dropout draw: "
                             "forward(x, keep=model.sample_dropout(n, generator))")
        got = [tuple(k.shape) for k in keep]
        if got != shapes:
            raise ValueError(f"SegFormer keep masks {got}, expected {shapes}")

    def _branch_scales(self, keep: Sequence[torch.Tensor]) -> torch.Tensor:
        """The blocks' per-sample branch scales, ``keep / (1 - rate)``, as one
        float32 (N, 2 B) tensor over the B blocks of nonzero rate, two
        columns each (two kernels for all of them): :func:`_blocks` views a
        block's two."""
        rated = [b for b in self.blocks if b.rate > 0]
        inv = self._constant("keep_scale", [1.0 / (1.0 - b.rate) for b in rated for _ in "ab"],
                             keep[0].device)
        return torch.where(torch.stack(list(keep[:2 * len(rated)]), 1), inv, 0.0)

    def _graphs_apply(self, x: torch.Tensor) -> bool:
        """Whether this forward replays the stages' CUDA graphs: a training
        forward on CUDA, recording autograd, inside the train step's
        :func:`~tpu_unet_torch.models.blocks.graph_replay`."""
        return (x.is_cuda and self.training and torch.is_grad_enabled()
                and replaying_graphs())

    def _stage_sizes(self, h: int, w: int) -> List[Tuple[int, int]]:
        """Each stage's map size for an h x w input."""
        sizes = []
        for pe, _, _ in self.backbone.stages():
            (k, _), (s, _), (p, _) = pe.proj.kernel_size, pe.proj.stride, pe.proj.padding
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            sizes.append((h, w))
        return sizes

    def _graphed_stages(self, x: torch.Tensor) -> List[Tuple]:
        """Each stage's blocks as one graphed callable with the parameters it
        takes after its activations, for inputs of ``x``'s shape: captured at
        the first such forward (``torch.cuda.make_graphed_callables``: a
        forward and a backward graph each, one memory pool) and kept while
        the shape and the parameters' memory stay; another shape replaces
        them. A stage was captured on aliases of its parameters (the same
        memory, so a replay copies none of them, but other leaves, so that
        autograd accumulates into the parameters with nodes made in the step
        itself), and on placeholders of its own for the residual stream and
        its blocks' (N, 2 k) branch scales."""
        n, _, h, w = x.shape
        key = ((n, h, w, x.device), tuple(p.data_ptr() for p in self.parameters()))
        if self._graph_key != key:
            self._drop_graphs()
            cd, fns, args = self.policy.compute_dtype, [], []
            for (_, blocks, _), (sh, sw) in zip(self.backbone.stages(), self._stage_sizes(h, w)):
                c = blocks[0].norm1.normalized_shape[0]
                k = 2 * sum(b.rate > 0 for b in blocks)
                fns.append(_capturable(blocks, sh, sw, cd))
                args.append((torch.randn(n, sh * sw, c, device=x.device, requires_grad=True),
                             torch.ones(n, k, device=x.device),
                             *(p.detach().requires_grad_() for p in blocks.parameters())))
            graphed = torch.cuda.make_graphed_callables(tuple(fns), tuple(args),
                                                        allow_unused_input=True)
            self._graphs = [(g, tuple(blocks.parameters()))
                            for g, (_, blocks, _) in zip(graphed, self.backbone.stages())]
            self._graph_key = key
        return self._graphs

    def _drop_graphs(self) -> None:
        """Releases the stages' graphs and their memory pool, if any, before
        another capture: two captures' pools do not fit beside each other at
        B5 widths and b16 1024x512."""
        if self._graphs is not None:
            self._graphs = self._graph_key = None
            gc.collect()  # a graphed callable's classes hold its graphs in cycles
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()

    def forward(self, x: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        cd = self.policy.compute_dtype
        n, _, h_in, w_in = x.shape
        if h_in % 32 or w_in % 32:
            raise ValueError(f"SegFormer takes sizes divisible by 32, got {h_in}x{w_in}")
        scales = x.new_ones(n, 0, dtype=torch.float32)
        head_keep = None
        if self.training and self.keep_shapes(n):
            self._check_keep(keep, n)
            keep = [k.to(x.device) for k in keep]
            if any(b.rate > 0 for b in self.blocks):
                scales = self._branch_scales(keep)
            head_keep = keep[-1] if self.dropout > 0 else None
        graphed = self._graphed_stages(x) if self._graphs_apply(x) else None
        feats, col = [], 0
        with span("segformer.encoder"):
            y = x.to(cd)
            for i, (pe, blocks, norm) in enumerate(self.backbone.stages()):
                p = pe.proj
                y = F.conv2d(y, p.weight.to(cd), p.bias.to(cd), pe.stride, p.padding)
                h, w = y.shape[2:]
                t = F.layer_norm(tokens(y).float(), (y.shape[1],), pe.norm.weight,
                                 pe.norm.bias, pe.norm.eps)
                k = 2 * sum(b.rate > 0 for b in blocks) if scales.shape[1] else 0
                for block in blocks:
                    block.count(n, h, w)
                if graphed:
                    g, params = graphed[i]
                    t = g(t, scales[:, col:col + k], *params)
                else:
                    t = _blocks(blocks, t, scales[:, col:col + k], h, w, cd)
                col += k
                t = F.layer_norm(t, (t.shape[2],), norm.weight, norm.bias, norm.eps)
                y = as_map(t.to(cd), h, w)
                feats.append(y)
        with span("segformer.decoder"):
            return self._head(feats, head_keep, (h_in, w_in))

    def _head(self, feats: List[torch.Tensor], keep, size_hw: Tuple[int, int]) -> torch.Tensor:
        cd = self.policy.compute_dtype
        d = self.decode_head
        h1, w1 = feats[0].shape[2:]
        maps = []
        for i, f in enumerate(feats):
            lin = getattr(d, f"linear_c{i + 1}").proj
            y = as_map(F.linear(tokens(f), lin.weight.to(cd), lin.bias.to(cd)), *f.shape[2:])
            maps.append(upsample_bilinear_half_pixel(y, h1 // f.shape[2]))
        y = torch.cat(maps[::-1], dim=1)
        fuse = d.linear_fuse
        y = F.relu(conv_bn(fuse.conv, fuse.bn, y, self.policy))
        if keep is not None:
            y = torch.where(keep[:, :, None, None], y, 0.0) / (1.0 - self.dropout)
        pred = d.linear_pred
        y = F.conv2d(y.to(cd), pred.weight.to(cd), pred.bias.to(cd))
        y = self.policy.cast_to_output(y)
        return upsample_bilinear_half_pixel(y, size_hw[0] // h1)


def _linear(z: torch.Tensor, fc: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    return F.linear(z, fc.weight.to(cd), fc.bias.to(cd))


def _blocks(blocks, t: torch.Tensor, scales: torch.Tensor, h: int, w: int, cd: torch.dtype,
            params: Optional[Sequence[dict]] = None) -> torch.Tensor:
    """A stage's blocks on its residual stream ``t``: each block of nonzero
    rate takes the next two columns of the stage's (N, 2 k) ``scales`` as
    its branches' (N, 1, 1) scales where ``scales`` has columns, else none;
    ``params``, one dict a block, stand in for the blocks' parameters."""
    c = 0
    for b, block in enumerate(blocks):
        pair = ()
        if block.rate > 0 and scales.shape[1]:
            pair, c = (scales[:, c, None, None], scales[:, c + 1, None, None]), c + 2
        kw = {"h": h, "w": w, "cd": cd}
        t = block(t, pair, **kw) if params is None else \
            functional_call(block, params[b], (t, pair), kw)
    return t


def _capturable(blocks, h: int, w: int, cd: torch.dtype):
    """A stage's blocks as a function of tensors alone, for
    ``make_graphed_callables``: the stream, the stage's (N, 2 k) scales,
    then tensors that stand in for the blocks' parameters, in order."""
    names = [[k for k, _ in block.named_parameters()] for block in blocks]

    def run(t, scales, *rest):
        params, i = [], 0
        for nm in names:
            params.append(dict(zip(nm, rest[i:i + len(nm)])))
            i += len(nm)
        return _blocks(blocks, t, scales, h, w, cd, params)
    return run


def _residual(t: torch.Tensor, y: torch.Tensor, scale: Tuple) -> torch.Tensor:
    """``t + dp(y)``: ``y`` times its per-sample (N, 1, 1) scale, keep over
    ``1 - rate`` (stochastic depth), where ``scale`` holds one, or ``y``
    itself."""
    return torch.addcmul(t, y, scale[0]) if scale else t + y
