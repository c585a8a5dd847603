"""K2: fused int8 3x3 conv with its requant epilogue (``csrc/conv3x3_int8.cu``).

Counterpart of ``tpu_unet/ops/pallas/int8_conv.py::conv3x3_int8_fused``: an
int8 NHWC 3x3 SAME stride-1 conv with int32 accumulation, then
``clip(round(relu(acc * scale[c] + bias[c]) / out_scale), lo, 127)`` written
as int8 (``lo`` = 0 after ReLU, -127 without). It is the conv of
``ops/quantize.py::_QuantExec.double_conv``.

Weight layout ("K2's layout"): ``(Cout, 3, 3, Cin)`` int8, i.e. OHWI, so each
output channel's taps are contiguous along Cin, as the kernel's B operand
wants. ``w`` may come with its Cin zero-padded to the kernel's channel
multiple (:func:`pad_channels`), as weights that serve many calls are kept.
``scale`` (= s_in * w_scale) and ``bias`` are ``(Cout,)`` float32 and
``out_scale`` a one-element float32 tensor, all on the input's device.

:func:`conv3x3_int8_plain` is the same function in plain PyTorch and is exact:
it accumulates in float64, where every partial sum of int8 products is an
integer below 2**53 (float32 stops being exact once 9 * Cin * 127**2 >= 2**24,
i.e. for Cin >= 116). The wrapper :func:`conv3x3_int8` runs the plain version
for CPU tensors and the kernel for CUDA tensors; ``conv3x3_int8.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_unet_torch.ops.kernels import build

_CIN_MULTIPLE = 32  # the kernel's channel slice (one mma k-step)


def pad_channels(t: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last (channel) dim up to the kernel's channel multiple."""
    pad = -t.shape[-1] % _CIN_MULTIPLE
    return F.pad(t, (0, pad)) if pad else t


def conv3x3_int8_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, out_scale: torch.Tensor,
                       relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K2 (``_QuantExec.double_conv``'s body)."""
    w = w[..., :x.shape[3]]  # drop pad_channels' zeros
    acc = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64),
                   w.permute(0, 3, 1, 2).to(torch.float64), padding=1)
    # acc holds exact integers below 2**31, so this cast rounds as int32 -> f32 does.
    y = acc.to(torch.float32) * scale.view(1, -1, 1, 1)
    y = y + bias.view(1, -1, 1, 1)
    lo = -127
    if relu:
        y = torch.relu(y)
        lo = 0
    q = torch.round(y / out_scale.reshape(()))
    return q.clamp(lo, 127).to(torch.int8).permute(0, 2, 3, 1).contiguous()


def _check(x, w, scale, bias, out_scale) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"conv3x3_int8 takes int8 x and w, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:3]) != (3, 3) \
            or w.shape[3] not in (x.shape[3], x.shape[3] + -x.shape[3] % _CIN_MULTIPLE):
        raise ValueError(f"conv3x3_int8 takes x (N,H,W,Cin) and w (Cout,3,3,Cin), "
                         f"Cin of w optionally padded by pad_channels, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    cout = w.shape[0]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be float32 of shape ({cout},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if out_scale.dtype != torch.float32 or out_scale.numel() != 1:
        raise ValueError("out_scale must be a one-element float32 tensor")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias),
                    ("out_scale", out_scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"conv3x3_int8 takes contiguous tensors ({name} is not)")


def conv3x3_int8(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, out_scale: torch.Tensor,
                 relu: bool = True) -> torch.Tensor:
    """int8 (N, H, W, Cin) x (Cout, 3, 3, Cin) -> requantized int8 (N, H, W, Cout).

    On CUDA, Cin that is not a multiple of 32 (the first layer's 3 channels)
    is zero-padded here: one extra pass that writes the padded input (32
    bytes a pixel instead of 3), and one over ``w`` unless it came padded.
    """
    _check(x, w, scale, bias, out_scale)
    if x.device.type == "cpu":
        return conv3x3_int8_plain(x, w, scale, bias, out_scale, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_int8 runs on cpu or cuda, not {x.device}")
    n, h, wd, _ = x.shape
    cout = w.shape[0]
    x, w = pad_channels(x), pad_channels(w)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3_int8 needs 16-byte aligned x and w on CUDA "
                         "(a view at an odd offset: pass a contiguous copy)")
    out = torch.empty((n, h, wd, cout), dtype=torch.int8, device=x.device)
    lib = build.load("conv3x3_int8")
    err = lib.tpu_unet_conv3x3_int8(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out_scale.data_ptr(), out.data_ptr(), n, h, wd, x.shape[3], cout,
        int(relu), build.current_stream(x.device))
    build.check(lib, "conv3x3_int8", err)
    conv3x3_int8.launches += 1
    return out


conv3x3_int8.launches = 0
