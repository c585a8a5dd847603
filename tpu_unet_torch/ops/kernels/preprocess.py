"""K1: fused uint8 -> normalized float (``csrc/normalize_u8.cu``).

Counterpart of ``tpu_unet/ops/pallas/preprocess.py::normalize_u8_pallas``. It
computes ``eval_transform``: ``(x / 255 - mean[c]) / std[c]`` over an NHWC
uint8 batch, written as float32 (or bfloat16 when asked) in one pass.

:func:`normalize_u8_plain` is the same function in plain PyTorch, in the same
order of operations. The kernel is a table lookup: a uint8 value in one of 3
channels has 768 possible results, and each block of the kernel computes them
with the same IEEE operations in the same order, so the kernel and the plain
version agree bit for bit. The wrapper :func:`normalize_u8` runs the plain
version for CPU tensors and the kernel for CUDA tensors, through the
operator ``torch.ops.tpu_unet_torch.normalize_u8`` (a ``torch.library``
custom op with a fake implementation, so ``torch.export`` records it in a
program and the loaded program dispatches the same way);
``normalize_u8.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tpu_unet_torch.ops.augment import IMAGENET_MEAN, IMAGENET_STD, normalize, to_float
from tpu_unet_torch.ops.kernels import build

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def normalize_u8_plain(images_u8: torch.Tensor,
                       mean: Tuple[float, ...] = IMAGENET_MEAN,
                       std: Tuple[float, ...] = IMAGENET_STD,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K1 (eval_transform's arithmetic)."""
    return normalize(to_float(images_u8), mean, std).to(out_dtype)


def _check(images_u8: torch.Tensor, mean, std, out_dtype) -> None:
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"normalize_u8 takes uint8 images, got {images_u8.dtype}")
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"normalize_u8 takes (N, H, W, 3) images, got "
                         f"{tuple(images_u8.shape)}")
    if len(mean) != 3 or len(std) != 3:
        raise ValueError("mean and std need 3 channels")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if not images_u8.is_contiguous():
        raise ValueError("normalize_u8 takes NHWC-contiguous images")


@torch.library.custom_op("tpu_unet_torch::normalize_u8", mutates_args=())
def _normalize_u8_op(images_u8: torch.Tensor, mean: Sequence[float], std: Sequence[float],
                     out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version for a CPU tensor; the kernel for a CUDA tensor."""
    if images_u8.device.type == "cpu":
        return normalize_u8_plain(images_u8, tuple(mean), tuple(std), out_dtype)
    if images_u8.device.type != "cuda":
        raise ValueError(f"normalize_u8 runs on cpu or cuda, not {images_u8.device}")
    out = torch.empty(images_u8.shape, dtype=out_dtype, device=images_u8.device)
    lib = build.load("normalize_u8")
    err = lib.tpu_unet_normalize_u8(
        images_u8.data_ptr(), out.data_ptr(), images_u8.numel(),
        int(out_dtype == torch.bfloat16), *mean, *std,
        build.current_stream(images_u8.device))
    build.check(lib, "normalize_u8", err)
    normalize_u8.launches += 1
    return out


@_normalize_u8_op.register_fake
def _(images_u8, mean, std, out_dtype):
    return images_u8.new_empty(images_u8.shape, dtype=out_dtype)


def normalize_u8(images_u8: torch.Tensor,
                 mean: Tuple[float, ...] = IMAGENET_MEAN,
                 std: Tuple[float, ...] = IMAGENET_STD,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> normalized (N, H, W, 3) ``out_dtype``."""
    _check(images_u8, mean, std, out_dtype)
    return _normalize_u8_op(images_u8, list(mean), list(std), out_dtype)


normalize_u8.launches = 0
