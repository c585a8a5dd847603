"""The int8 up block's concat in one pass (``csrc/up_concat_int8.cu``).

An int8 up block (``ops/quantize.py::_QuantExec.up_block``) concatenates
its skip with the level-up of the coarser tensor, both requantized to one
shared scale ``s_cat``. The level-up is a k2s2 transposed conv: one int8
matmul gives the int32 accumulator ``(N*h*w, 4*Cout)``, whose column
``(2a + b) * Cout + c`` is output pixel ``(2i + a, 2j + b)``'s channel ``c``.
This operator takes the skip ``(N, 2h, 2w, Cs)`` int8 at ``s_skip`` and that
accumulator (a ``[:m, :n]`` view of a padded product is fine: its row
stride is read) with the per-column ``scale`` (``s_in * w_scale``) and
``bias``, ``(4*Cout,)`` float32, and returns the concat ``(N, 2h, 2w, Cs +
Cout)`` int8: the skip requantized ``skip * s_skip / s_cat``, then the
pixel-shuffled ``(acc * scale + bias) / s_cat``, each rounded half to even
and clamped to [-127, 127].

It replaces no TPU kernel: XLA fuses this epilogue for the JAX package.
:func:`up_concat_int8_plain` is the same function in plain PyTorch (the
composition the executor ran before the kernel) and the kernel agrees with
it bit for bit. The wrapper :func:`up_concat_int8` runs the plain version
for CPU tensors and the kernel for CUDA tensors, through the operator
``torch.ops.tpu_unet_torch.up_concat_int8`` (a ``torch.library`` custom op
with a fake implementation, so ``torch.export`` records it);
``up_concat_int8.launches`` counts kernel launches. Each call of the wrapper
is one ``kernel.up_concat`` span (``utils/spans.py``), on either device.
"""

from __future__ import annotations

import torch

from tpu_unet_torch.ops.kernels import build
from tpu_unet_torch.utils.spans import span


def requant(y_f32: torch.Tensor, scale: torch.Tensor, lo: int = -127) -> torch.Tensor:
    """float32 -> int8 at ``scale``: ``clamp(round(y / scale), lo, 127)``,
    rounding half to even. ``scale`` is a tensor on ``y``'s device."""
    return torch.round(y_f32 / scale).clamp_(lo, 127).to(torch.int8)


def level_up_plain(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   s_cat: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """The transposed conv's epilogue in plain PyTorch: the accumulator
    (n*h*w, 4*Cout) requantized to ``s_cat`` and pixel-shuffled to
    (n, 2h, 2w, Cout) int8."""
    cout = acc.shape[1] // 4
    y = acc.to(torch.float32) * scale
    y = y + bias
    q_up = requant(y, s_cat).view(n, h, w, 2, 2, cout)
    return q_up.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, cout)


def up_concat_int8_plain(skip: torch.Tensor, s_skip: torch.Tensor, acc: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         s_cat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (see the module docstring)."""
    n, h2, w2, _ = skip.shape
    q_up = level_up_plain(acc, scale, bias, s_cat, n, h2 // 2, w2 // 2)
    return torch.cat([requant(skip.to(torch.float32) * s_skip, s_cat), q_up], dim=-1)


def _check(skip, s_skip, acc, scale, bias, s_cat) -> None:
    if skip.dtype != torch.int8 or acc.dtype != torch.int32:
        raise TypeError(f"up_concat_int8 takes an int8 skip and an int32 accumulator, got "
                        f"{skip.dtype}, {acc.dtype}")
    if skip.dim() != 4 or skip.shape[1] % 2 or skip.shape[2] % 2:
        raise ValueError(f"up_concat_int8 takes a skip (N, 2h, 2w, Cs), got "
                         f"{tuple(skip.shape)}")
    n, h2, w2, _ = skip.shape
    if (acc.dim() != 2 or acc.shape[0] != n * (h2 // 2) * (w2 // 2) or acc.shape[1] % 4
            or acc.shape[1] == 0):
        raise ValueError(f"up_concat_int8 takes an accumulator ({n * (h2 // 2) * (w2 // 2)}, "
                         f"4 * Cout) for a skip {tuple(skip.shape)}, got {tuple(acc.shape)}")
    if acc.stride(1) != 1 or (acc.shape[0] > 1 and acc.stride(0) < acc.shape[1]):
        raise ValueError("up_concat_int8 takes an accumulator whose columns are contiguous "
                         "and whose rows do not overlap")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (acc.shape[1],):
            raise ValueError(f"{name} must be float32 of shape ({acc.shape[1]},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("s_skip", s_skip), ("s_cat", s_cat)):
        if t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"{name} must be a one-element float32 tensor")
    for name, t in (("s_skip", s_skip), ("acc", acc), ("scale", scale), ("bias", bias),
                    ("s_cat", s_cat)):
        if t.device != skip.device:
            raise ValueError(f"{name} is on {t.device}, skip on {skip.device}")
    for name, t in (("skip", skip), ("scale", scale), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"up_concat_int8 takes a contiguous {name}")


def _launch(skip, s_skip, acc, scale, bias, s_cat):
    """The kernel on CUDA tensors (see :func:`up_concat_int8`)."""
    n, h2, w2, cs = skip.shape
    cout = acc.shape[1] // 4
    out = torch.empty((n, h2, w2, cs + cout), dtype=torch.int8, device=skip.device)
    lib = build.load("up_concat_int8")
    with torch.cuda.device(skip.device):
        err = lib.tpu_unet_up_concat_int8(
            skip.data_ptr(), s_skip.data_ptr(), acc.data_ptr(), acc.stride(0),
            scale.data_ptr(), bias.data_ptr(), s_cat.data_ptr(), out.data_ptr(),
            n, h2 // 2, w2 // 2, cs, cout, build.current_stream(skip.device))
    build.check(lib, "up_concat_int8", err)
    with build.LOCK:
        up_concat_int8.launches += 1
    return out


@torch.library.custom_op("tpu_unet_torch::up_concat_int8", mutates_args=())
def _up_concat_int8_op(skip: torch.Tensor, s_skip: torch.Tensor, acc: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       s_cat: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU tensors; the kernel for CUDA tensors."""
    if skip.device.type == "cpu":
        return up_concat_int8_plain(skip, s_skip, acc, scale, bias, s_cat)
    if skip.device.type != "cuda":
        raise ValueError(f"up_concat_int8 runs on cpu or cuda, not {skip.device}")
    return _launch(skip, s_skip, acc, scale, bias, s_cat)


@_up_concat_int8_op.register_fake
def _(skip, s_skip, acc, scale, bias, s_cat):
    n, h2, w2, cs = skip.shape
    return skip.new_empty((n, h2, w2, cs + acc.shape[1] // 4))


def up_concat_int8(skip: torch.Tensor, s_skip: torch.Tensor, acc: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor, s_cat: torch.Tensor) -> torch.Tensor:
    """int8 skip (N, 2h, 2w, Cs) and int32 accumulator (N*h*w, 4*Cout) ->
    their int8 concat (N, 2h, 2w, Cs + Cout) at ``s_cat``."""
    with span("kernel.up_concat"):
        _check(skip, s_skip, acc, scale, bias, s_cat)
        return _up_concat_int8_op(skip, s_skip, acc, scale, bias, s_cat)


up_concat_int8.launches = 0
