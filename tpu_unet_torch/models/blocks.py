"""UNet building blocks as PyTorch modules (counterpart of
``tpu_unet/models/blocks.py``).

Module and parameter names follow the reference state_dict
(``double_conv.{0,1,3,4}``, ``maxpool_conv.1``, ``up``/``conv``, ``conv``; a
bilinear ``Up`` has no ``up``), so a reference-layout checkpoint loads with
``strict=True``; an attention-gated ``Up``'s gate is ``att``
(``models/attention.py``). Tensors are NCHW (channels_last in memory on the
GPU), PyTorch's habit.

Precision follows the policy, as in the JAX blocks: convolutions run in the
compute dtype with float32 parameters cast at use; the BN affine (or, once
``ops/fold_bn.py`` has folded it, the conv bias) and ReLU run in float32, and
the result is cast back to the compute dtype. The transposed conv and the
1x1 head add their bias in the compute dtype; heads return float32. The
bilinear upsample runs in the compute dtype, as matmuls
(``ops/resize.py``). A BN-folded DoubleConv served in bf16 on the card runs
that bias, ReLU and cast as one pass over the bf16 conv output
(:func:`fuses_epilogue`, ``ops/kernels/bias_relu.py``), with the same
arithmetic; ``COUNTERS`` counts the epilogues of the two routes.

BatchNorm follows flax's, as the JAX blocks configure it: eps 1e-5; in train
mode it normalizes by the batch's biased variance and moves the running
statistics by 0.1 (torch's convention; flax ``momentum=0.9``) towards the
batch mean and the *biased* batch variance, where ``nn.BatchNorm2d`` would
take the unbiased one. Eval mode is ``nn.BatchNorm2d``'s own forward.

Tensor parallelism (``parallel/tensor.py::shard_state``) leaves each rank
a channel slice of the sharded convs and BatchNorms and tags each sharded
conv ``tp`` 'column' or 'row'. :func:`conv_bn` and :func:`up_conv` then put
the collectives over the 'model' group around it: before a column conv the
identity whose backward all-reduces the input's gradient, after a row conv
the all-reduce of the partial sums (in float32, after the cast to the norm
dtype, so under the bf16 policy the ranks' partials are added in float32),
after a column transposed conv the all-gather of the channel slices.

Rematerialization (the train steps' ``remat``): ``DoubleConv``, ``Down`` and
``Up`` take a ``remat_tag``; under :func:`remat_scope` of that tag a block
runs under :func:`checkpoint`, which keeps only its inputs and recomputes the
rest in the backward. The recomputation runs in :func:`recomputing` mode, in
which a train-mode BatchNorm normalizes by the batch statistics as before and
leaves its running statistics alone, so they move once per step, as flax's
functional ``batch_stats`` do under ``jax.checkpoint``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from tpu_unet_torch.core.precision import DEFAULT_POLICY, Policy
from tpu_unet_torch.ops.kernels.bias_relu import bias_relu_bf16
from tpu_unet_torch.ops.resize import upsample2x_bilinear_align_corners
from tpu_unet_torch.parallel import spatial
from tpu_unet_torch.parallel.tensor import copy_to_model, gather_channels, reduce_from_model


_STATE = threading.local()  # per thread: the remat scope's tag, recomputing

# DoubleConv epilogues by route (:func:`fuses_epilogue`).
COUNTERS = {"fused_epilogues": 0, "composed_epilogues": 0}
_COUNTERS_LOCK = threading.Lock()  # serving replicas run on threads of their own


def refuse_train_only(model: nn.Module, what: str) -> None:
    """ValueError when ``model`` trains through the seg step alone (its class
    sets ``train_only``: TransUNet, SegFormer), which ``what`` does not
    support."""
    if getattr(model, "train_only", False):
        raise ValueError(f"{what} does not support {type(model).__name__}: it trains "
                         "through the segmentation train step on one device, and is "
                         "served by none of the port's engines")


def _count(route: str) -> None:
    with _COUNTERS_LOCK:
        COUNTERS[route] += 1


def recomputing() -> bool:
    """Whether this thread is recomputing a checkpointed forward."""
    return getattr(_STATE, "recomputing", False)


def replaying_graphs() -> bool:
    """Whether this thread's forward is inside :func:`graph_replay`."""
    return getattr(_STATE, "graphs", False)


@contextlib.contextmanager
def graph_replay():
    """Lets a model replay CUDA graphs in the training forward this thread
    runs inside (``models/segformer.py``). A graph's backward hands out its
    own gradient buffers as the parameters' ``.grad``, which its next replay
    overwrites; so the train step opens this only around a forward whose one
    backward writes gradients that ``zero_grad(set_to_none=True)`` has just
    cleared and that the optimizer reads before the next replay: the step's
    first microbatch, on parameters of its own (no data group), with
    nothing recomputed."""
    before = replaying_graphs()
    _STATE.graphs = True
    try:
        yield
    finally:
        _STATE.graphs = before


@contextlib.contextmanager
def _recompute_mode():
    before = recomputing()
    _STATE.recomputing = True
    try:
        yield
    finally:
        _STATE.recomputing = before


def checkpoint(fn, *args):
    """``fn(*args)``, keeping ``args`` and recomputing the rest in the
    backward (``torch.utils.checkpoint``, non-reentrant) in
    :func:`recomputing` mode, under the 'space' scope of the forward (the
    backward may run in another thread), whose row exchanges it reruns in
    the forward's order."""
    ex, plan = spatial.current(), spatial.current_plan()
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute_scope(ex, plan)))


@contextlib.contextmanager
def _recompute_scope(ex, plan):
    with _recompute_mode(), spatial.scope(ex, plan=plan):
        yield


@contextlib.contextmanager
def remat_scope(tag: Optional[str]):
    """Blocks built with ``remat_tag == tag`` run under :func:`checkpoint`
    inside this scope (in this thread)."""
    before = getattr(_STATE, "tag", None)
    _STATE.tag = tag
    try:
        yield
    finally:
        _STATE.tag = before


def _remat(tag: Optional[str]) -> bool:
    return tag is not None and getattr(_STATE, "tag", None) == tag


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates ``running_var`` with the
    biased batch variance, as flax does, and not at all while
    :func:`recomputing`. Statistics are float32 (the policy's
    ``norm_dtype``); parameter and buffer names are unchanged.

    With a ``process_group`` (:func:`sync_batchnorm`) train mode takes the
    statistics of the global batch, as flax's BatchNorm does over a
    'data'-sharded batch (:class:`_GlobalBatchNorm`: an all-reduce of (sum
    x, sum x^2, count) in float32 and its derivative, the biased variance in
    flax's form E[x^2] - E[x]^2), and the running statistics move by the
    global values."""

    process_group = None  # not a parameter or buffer: state_dicts keep their names

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            out, mean, var = self._global_batch_norm(x)
        else:
            out, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            # The kernel saved 1 / sqrt(var + eps); var is recovered from it.
            var = None if recomputing() else \
                invstd.detach().double().pow(-2).sub(self.eps).clamp(min=0).float()
        if recomputing():
            return out
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            f = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                 else self.momentum)
            self.running_mean.mul_(1.0 - f).add_(mean.detach(), alpha=f)
            self.running_var.mul_(1.0 - f).add_(var.detach(), alpha=f)
        return out

    def _global_batch_norm(self, x: torch.Tensor):
        return _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self.process_group)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over a process group's global batch, in float32.

    Forward: one all-reduce of (sum x, sum x^2, count), the biased variance
    as flax takes it, E[x^2] - E[x]^2, and the normalization as a fused
    inference-mode batch norm. Backward: the all-reduce differentiated, one
    all-reduce of (sum dy, sum dy (x - mean)), so each rank's input gradient
    carries the other ranks' terms: dx = w invstd (dy - mean_g(dy) - (x -
    mean) invstd^2 mean_g(dy (x - mean))). The weight and bias gradients are
    the rank's own sums, which the train step averages with the others.
    Returns (out, mean, var); the statistics carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        stats = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                           x.new_full((1,), x.numel() // c)])
        dist.all_reduce(stats, group=group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        out = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps), n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        shape = (1, c, 1, 1)
        xmu = x - mean.view(shape)
        sums = torch.cat([dy.sum(dim=(0, 2, 3)), (dy * xmu).sum(dim=(0, 2, 3))])
        grad_weight, grad_bias = sums[c:] * invstd, sums[:c].clone()
        dist.all_reduce(sums, group=ctx.group)
        k = invstd * weight
        # dy k - mean_g(dy) k - xmu invstd^2 mean_g(dy xmu) k, in two fused passes
        dx = torch.addcmul((-sums[:c] / n * k).view(shape), dy, k.view(shape))
        dx = torch.addcmul(dx, xmu, (sums[c:] / n * invstd * invstd * k).view(shape), value=-1)
        return dx, grad_weight, grad_bias, None, None


def sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Give every :class:`BatchNorm2d` of ``model`` the process group whose
    global batch its train mode normalizes by (None: this rank's batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
    return model


def conv_bn(conv: nn.Conv2d, norm: nn.Module, x: torch.Tensor, policy: Policy,
            padding: int = 0, stride: int = 1, level: int = 0) -> torch.Tensor:
    """A bias-free conv in the compute dtype, then its BatchNorm in float32
    (after ``ops/fold_bn.py``, the conv's float32 bias and an identity).
    ``stride`` 2 (a 1x1 conv) samples the even rows and columns first: the
    same sums as a stride-2 conv, whose backward on a channels_last CPU
    tensor corrupts memory in PyTorch's CPU build. A tensor-parallel conv
    (module docstring) takes its collective: a row conv's all-reduce runs on
    the float32 output, before the bias. Under a 'space' scope
    (``parallel/spatial.py``) ``x`` holds the rank's rows of ``level`` (a
    stride-2 conv's: the rows ``spatial.stride2_rows`` gives); a padded conv
    takes one halo row above and below from the ranks that hold them and
    pads the columns only, which gives exactly the rank's rows of the whole
    image's conv. A rank with no rows at the level runs the conv on zero
    rows and keeps none of its output, so that its backward takes part in
    the exchanges."""
    y = _conv(conv, x, policy, policy.norm_dtype, padding, stride, level)
    if conv.bias is not None:  # BN folded into the conv (ops/fold_bn.py)
        y = y + conv.bias.view(-1, 1, 1)
    return norm(y)


def _conv(conv: nn.Conv2d, x: torch.Tensor, policy: Policy, out_dtype: torch.dtype,
          padding: int = 0, stride: int = 1, level: int = 0) -> torch.Tensor:
    """:func:`conv_bn`'s conv without the bias: its output cast to
    ``out_dtype``, with the tensor-parallel and 'space' handling."""
    cd = policy.compute_dtype
    if stride > 1:
        x = x[:, :, ::stride, ::stride]
    tp = getattr(conv, "tp", None)
    x = x.to(cd)
    if tp == "column":
        x = copy_to_model(x, conv.tp_group)
    min_rows = 1
    if padding and spatial.current() is not None:
        if padding != 1:
            raise ValueError(f"a 'space' halo is one row; got padding {padding}")
        x, padding, min_rows = spatial.halo(x, level), (0, 1), 3

    def conv_rows(t):
        y = F.conv2d(t, conv.weight.to(cd), padding=padding).to(out_dtype)
        return reduce_from_model(y, conv.tp_group) if tp == "row" else y

    return spatial.empty_safe(conv_rows, x, min_rows)


def _on_card(x: torch.Tensor) -> bool:
    """:func:`fuses_epilogue`'s device test (the CPU tests patch it to
    force the fused route onto the operator's plain version)."""
    return x.is_cuda


def fuses_epilogue(conv: nn.Conv2d, norm: nn.Module, x: torch.Tensor, policy: Policy) -> bool:
    """Whether a DoubleConv's conv -> norm -> ReLU -> cast on ``x`` runs as
    one bias-ReLU-cast pass over the bf16 conv output
    (``ops/kernels/bias_relu.py``): only a BN-folded conv (a bias, the norm
    an identity) that is not tensor-parallel (a row conv all-reduces its
    partial sums in float32 before the bias), under a bf16 policy, on a
    CUDA tensor, where autograd records nothing (grad mode off, or no input
    or parameter that requires grad: the op has no backward). The
    arithmetic is the composed route's, bit for bit."""
    return (conv.bias is not None and isinstance(norm, nn.Identity)
            and getattr(conv, "tp", None) is None
            and policy.compute_dtype == torch.bfloat16 and _on_card(x)
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or conv.weight.requires_grad
                          or conv.bias.requires_grad)))


def up_conv(up: nn.ConvTranspose2d, x: torch.Tensor, cd: torch.dtype,
            level: int = 0) -> torch.Tensor:
    """The k2s2 transposed conv in the compute dtype, bias added there; a
    tensor-parallel one gathers its output channels from the 'model' ranks.
    Under a 'space' scope ``x`` holds the rank's rows of ``level + 1``, and
    the output comes to its rows of ``level``, zero-padded to the level's
    height as :class:`Up` pads the whole image (``spatial.pad_rows``)."""
    x = x.to(cd)
    tp = getattr(up, "tp", None) == "column"
    if tp:
        x = copy_to_model(x, up.tp_group)
    y = spatial.empty_safe(
        lambda t: F.conv_transpose2d(t, up.weight.to(cd), up.bias.to(cd), stride=2), x, 1)
    if tp:
        y = gather_channels(y, up.tp_group)
    return spatial.pad_rows(y, level)


def max_pool(x: torch.Tensor, level: int) -> torch.Tensor:
    """The 2x2 max-pool (stride 2) of ``x`` to ``level``; under a 'space'
    scope ``x`` holds the rank's rows of ``level - 1``, which first become
    the pairs of rows its rows of ``level`` pool (``spatial.pool_rows``)."""
    return spatial.empty_safe(lambda t: F.max_pool2d(t, 2), spatial.pool_rows(x, level), 2)


class DoubleConv(nn.Module):
    """(Conv3x3 no-bias -> BN -> ReLU) twice, optionally with a narrower mid
    width. ``level`` is the number of max-pools above it (the rows it runs
    on under a 'space' scope)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None,
                 policy: Policy = DEFAULT_POLICY, remat_tag: Optional[str] = None,
                 level: int = 0):
        super().__init__()
        mid = mid_channels if mid_channels is not None else out_channels
        self.policy, self.level = policy, level
        self.remat_tag = remat_tag
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, 3, padding=1, bias=False),
            BatchNorm2d(mid),
            nn.ReLU(inplace=True),
            nn.Conv2d(mid, out_channels, 3, padding=1, bias=False),
            BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _remat(self.remat_tag):
            return checkpoint(self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        for i in (0, 3):
            conv, norm = self.double_conv[i], self.double_conv[i + 1]
            if fuses_epilogue(conv, norm, x, self.policy):
                _count("fused_epilogues")
                y = _conv(conv, x, self.policy, cd, padding=1, level=self.level)
                x = bias_relu_bf16(y, conv.bias)
            else:
                _count("composed_epilogues")
                y = conv_bn(conv, norm, x, self.policy, padding=1, level=self.level)
                x = F.relu(y).to(cd)
        return x


class Down(nn.Module):
    """2x2 max-pool (stride 2) followed by DoubleConv (which takes the
    ``remat_tag``: the pooled input is kept) at ``level``, the pool's."""

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, remat_tag: Optional[str] = None,
                 level: int = 1):
        super().__init__()
        self.level = level
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2),
            DoubleConv(in_channels, out_channels, policy=policy, remat_tag=remat_tag,
                       level=level))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # maxpool_conv[0] keeps the reference's module names; the pool runs
        # through max_pool, which moves the rows it needs under 'space'.
        return self.maxpool_conv[1](max_pool(x, self.level))


class Up(nn.Module):
    """Upsample x1 2x, pad it to the skip's extent, concat(skip, x1), DoubleConv.

    ``in_channels`` is the concat's width. The transposed conv (``up``) maps
    x1's ``in_channels`` to half; the bilinear upsample (``bilinear=True``,
    align corners, no parameters) keeps x1's ``in_channels // 2`` and the
    DoubleConv narrows to ``in_channels // 2`` in the middle, as the
    reference's does. ``attention=True`` gates the skip through an
    :class:`~tpu_unet_torch.models.attention.AttentionGate` (``att``) before
    the upsample; the gating signal is the coarse x1. Under its
    ``remat_tag`` the whole block (upsample, pad, concat and DoubleConv) is
    checkpointed; x1 and the skip are kept. ``level`` is the skip's (x1 is
    one level below).
    """

    def __init__(self, in_channels: int, out_channels: int, bilinear: bool = False,
                 policy: Policy = DEFAULT_POLICY, attention: bool = False,
                 remat_tag: Optional[str] = None, level: int = 0):
        super().__init__()
        self.policy, self.level = policy, level
        self.remat_tag = remat_tag
        skip = in_channels // 2
        if attention:
            from tpu_unet_torch.models.attention import AttentionGate
            self.att = AttentionGate(in_channels // 2 if bilinear else in_channels, skip,
                                     f_int=max(1, skip // 2), policy=policy, level=level)
        if bilinear:
            self.conv = DoubleConv(in_channels, out_channels, in_channels // 2, policy=policy,
                                   level=level)
        else:
            self.up = nn.ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2)
            self.conv = DoubleConv(in_channels, out_channels, policy=policy, level=level)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if _remat(self.remat_tag):
            return checkpoint(self._forward, x1, x2)
        return self._forward(x1, x2)

    def _forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        if hasattr(self, "att"):
            x2 = self.att(x1, x2)
        if hasattr(self, "up"):
            x1 = up_conv(self.up, x1, cd, self.level)
        else:
            x1 = upsample2x_bilinear_align_corners(x1.to(cd), self.level)
        # Static pad to the skip's extent (zero for power-of-two sizes);
        # under a 'space' scope the level-up padded the rows already.
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2.to(x1.dtype), x1], dim=1))


class OutConv(nn.Module):
    """1x1 convolution head; output cast to the policy's output dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        y = F.conv2d(x.to(cd), self.conv.weight.to(cd), self.conv.bias.to(cd))
        return self.policy.cast_to_output(y)
