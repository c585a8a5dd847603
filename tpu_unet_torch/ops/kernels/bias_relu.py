"""The BN-folded bf16 conv's epilogue in one pass (``csrc/bias_relu_bf16.cu``).

Once ``ops/fold_bn.py`` has folded a DoubleConv's BatchNorm into its conv,
the block's epilogue is ``bf16(relu(float32(y) + bias))`` over the conv's
bf16 output ``y`` (N, C, H, W) and the folded float32 bias (C,): the
policy's float32 bias add and ReLU, then the cast back to the compute dtype.
Composed from PyTorch ops it is four passes over the activation (the
widening copy, the add, the ReLU, the narrowing copy), 28 bytes of traffic
per element where the conv writes 2.

It replaces no TPU kernel: XLA fuses this epilogue into the conv for the JAX
package. Its bound on the card is bytes, 2 read and 2 written per element;
the kernel moves 16-byte chunks of 8 bf16 in a grid-stride loop, each
chunk's biases in two float4 loads through the read-only cache (see the
source's note). It takes ``y`` dense in channels_last or in contiguous NCHW,
any C and any H * W: a C (channels_last) or an H * W (NCHW) that is not a
multiple of 8 takes the kernel's scalar path; any other strides are refused.
The output has ``y``'s layout.

:func:`bias_relu_bf16_plain` is the same function in plain PyTorch, the
composed chain the blocks ran before the kernel, and the kernel agrees with
it bit for bit (NaN kept, the sign of a zero as ``F.relu`` gives it, round
to nearest even). The wrapper :func:`bias_relu_bf16` runs the plain version
for CPU tensors and the kernel for CUDA tensors, through the operator
``torch.ops.tpu_unet_torch.bias_relu_bf16`` (a ``torch.library`` operator
with an implementation per device and a fake one, so ``torch.export``
records it); ``bias_relu_bf16.launches`` counts kernel launches (none for
an empty ``y``). Each call of the wrapper is one ``kernel.bias_relu`` span
(``utils/spans.py``), on either device. The op has no backward: the blocks
take it only where autograd records nothing (``models/blocks.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_unet_torch.ops.kernels import build
from tpu_unet_torch.utils.spans import span


def bias_relu_bf16_plain(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (see the module docstring)."""
    return F.relu(y.to(torch.float32) + bias.view(-1, 1, 1)).to(torch.bfloat16)


def _channels_last(y: torch.Tensor) -> bool:
    """Whether the kernel reads ``y`` as channels_last (else contiguous
    NCHW); raises for any other strides."""
    if y.is_contiguous(memory_format=torch.channels_last):
        return True
    if y.is_contiguous():
        return False
    raise ValueError(f"bias_relu_bf16 takes y dense in channels_last or contiguous NCHW, "
                     f"got strides {y.stride()}")


def _check(y: torch.Tensor, bias: torch.Tensor) -> None:
    if y.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise TypeError(f"bias_relu_bf16 takes a bfloat16 y and a float32 bias, got "
                        f"{y.dtype}, {bias.dtype}")
    if y.dim() != 4 or bias.shape != (y.shape[1],):
        raise ValueError(f"bias_relu_bf16 takes y (N, C, H, W) and a bias (C,), got "
                         f"{tuple(y.shape)}, {tuple(bias.shape)}")
    if bias.device != y.device:
        raise ValueError(f"bias is on {bias.device}, y on {y.device}")
    if not bias.is_contiguous():
        raise ValueError("bias_relu_bf16 takes a contiguous bias")
    _channels_last(y)


def _launch(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, launched on ``y``'s device and its
    current stream (see :func:`bias_relu_bf16`)."""
    out = torch.empty_like(y)  # y's dense layout, so element i is y's element i
    if y.numel() == 0:
        return out
    lib = build.load("bias_relu_bf16")
    err = lib.tpu_unet_bias_relu_bf16(
        y.data_ptr(), bias.data_ptr(), out.data_ptr(), y.numel(), y.shape[1],
        y.shape[2] * y.shape[3], int(_channels_last(y)), y.device.index,
        build.current_stream(y.device))
    build.check(lib, "bias_relu_bf16", err)
    with build.LOCK:
        bias_relu_bf16.launches += 1
    return out


# Registered by torch.library's define and per-device impl rather than the
# custom_op decorator, whose Python dispatch cost about 13 us of host a call
# on the card's host against about 5 (18 calls in every forward of a lone
# served image).
_NAME = "tpu_unet_torch::bias_relu_bf16"
torch.library.define(_NAME, "(Tensor y, Tensor bias) -> Tensor")
torch.library.impl(_NAME, "cpu", bias_relu_bf16_plain)
torch.library.impl(_NAME, "cuda", _launch)


@torch.library.register_fake(_NAME)
def _(y, bias):
    return torch.empty_like(y)


_OP = torch.ops.tpu_unet_torch.bias_relu_bf16.default


def bias_relu_bf16(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """bf16 conv output (N, C, H, W) and float32 bias (C,) ->
    ``bf16(relu(float32(y) + bias))``, in ``y``'s layout."""
    with span("kernel.bias_relu"):
        _check(y, bias)
        return _OP(y, bias)


bias_relu_bf16.launches = 0
