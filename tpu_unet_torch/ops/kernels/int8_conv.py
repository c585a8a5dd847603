"""K2: fused int8 3x3 conv with its requant epilogue (``csrc/conv3x3_int8.cu``).

Counterpart of ``tpu_unet/ops/pallas/int8_conv.py::conv3x3_int8_fused``: an
int8 NHWC 3x3 SAME stride-1 conv with int32 accumulation, then
``clip(round(relu(acc * scale[c] + bias[c]) / out_scale), lo, 127)`` written
as int8 (``lo`` = 0 after ReLU, -127 without). It is the conv of
``ops/quantize.py::_QuantExec.double_conv``.

Weights come in one of two forms, both int8:

- natural, ``(Cout, 3, 3, Cin)`` (OHWI);
- packed for the kernel (:func:`pack_weights`), as weights that serve many
  calls are kept: for Cin != 3, ``(Cin32 / 16, 9, Cout, 16)`` with Cin32 the
  padded Cin, element ``[k, t, o, i]`` = ``w[o, t // 3, t % 3, 16 k + i]``,
  so one TMA box brings a 32-channel k-step's nine taps as K-major tiles; for
  Cin = 3 (the first layer, RGB), :func:`pack_first_layer`'s ``(Cout, 32)``,
  ``[o, t * 3 + i]`` = ``w[o, t // 3, t % 3, i]`` and zeros after 27, so the
  whole kernel is one k32 step.

``scale`` (= s_in * w_scale) and ``bias`` are ``(Cout,)`` float32 and
``out_scale`` a one-element float32 tensor, all on the input's device.

The kernel writes 16 output channels at a time. On CUDA the wrapper takes
any Cout: natural weights, scale and bias are zero-padded to a multiple of 16
(:func:`pad_cout`) and the extra channels, all zero, are sliced off the
output. Weights that serve many calls are padded once with the same function
before :func:`pack_weights` (``ops/quantize.py::_QuantExec``): a zero channel
has a zero scale and bias, so padding is exact.

:func:`conv3x3_int8_plain` is the same function in plain PyTorch and is exact:
it accumulates in float64, where every partial sum of int8 products is an
integer below 2**53 (float32 stops being exact once 9 * Cin * 127**2 >= 2**24,
i.e. for Cin >= 116). The wrapper :func:`conv3x3_int8` runs the plain version
for CPU tensors and the kernel for CUDA tensors, through the operator
``torch.ops.tpu_unet_torch.conv3x3_int8`` (a ``torch.library`` custom op with a
fake implementation, so ``torch.export`` records it in a program);
``conv3x3_int8.launches`` counts kernel launches. Each call of the wrapper
is one ``kernel.k2`` span (``utils/spans.py``), on either device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_unet_torch.ops.kernels import build
from tpu_unet_torch.utils.spans import span

_CIN_MULTIPLE = 32  # the kernel's k-step (one wgmma k32)
_COUT_MULTIPLE = 16  # the kernel's output channels per store
_FIRST_LAYER_CIN = 3  # RGB: 9 taps x 3 channels fit one k-step


def _padded(cin: int) -> int:
    return cin + -cin % _CIN_MULTIPLE


def pad_cout(t: torch.Tensor) -> torch.Tensor:
    """Zero-pad the first (output-channel) dim up to the kernel's Cout
    multiple: natural (Cout, 3, 3, Cin) weights, or a (Cout,) scale or bias."""
    pad = -t.shape[0] % _COUT_MULTIPLE
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def pad_channels(t: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last (channel) dim up to the kernel's channel multiple
    (the wrapper pads ``x`` with it)."""
    pad = -t.shape[-1] % _CIN_MULTIPLE
    return F.pad(t, (0, pad)) if pad else t


def pack_first_layer(w: torch.Tensor) -> torch.Tensor:
    """Natural (Cout, 3, 3, 3) weights -> the first-layer kernel's (Cout, 32):
    taps x channels in one k32 step, zeros after 27."""
    if w.dim() != 4 or tuple(w.shape[1:]) != (3, 3, _FIRST_LAYER_CIN):
        raise ValueError(f"pack_first_layer takes (Cout, 3, 3, 3), got {tuple(w.shape)}")
    flat = w.reshape(w.shape[0], 9 * _FIRST_LAYER_CIN)
    return F.pad(flat, (0, _CIN_MULTIPLE - 9 * _FIRST_LAYER_CIN)).contiguous()


def pack_weights(w: torch.Tensor, cin: int) -> torch.Tensor:
    """Natural weights of a conv with ``cin`` input channels -> the layout
    the kernel reads (see the module docstring)."""
    if cin == _FIRST_LAYER_CIN:
        return pack_first_layer(w)
    w = F.pad(w, (0, -cin % _CIN_MULTIPLE))
    return w.reshape(w.shape[0], 9, -1, 16).permute(2, 1, 0, 3).contiguous()


def _packed_shape(cin: int, cout: int) -> tuple:
    if cin == _FIRST_LAYER_CIN:
        return (cout, _CIN_MULTIPLE)
    return (_padded(cin) // 16, 9, cout, 16)


def _is_natural(w: torch.Tensor, cin: int) -> bool:
    return w.dim() == 4 and tuple(w.shape[1:]) == (3, 3, cin)


def _cout(w: torch.Tensor, cin: int) -> int:
    """Cout of natural or packed weights (a packed Cin != 3 is (., 9, Cout, 16))."""
    return w.shape[2] if w.dim() == 4 and not _is_natural(w, cin) else w.shape[0]


def _natural(w: torch.Tensor, cin: int) -> torch.Tensor:
    """Natural or packed weights -> natural (Cout, 3, 3, cin)."""
    if _is_natural(w, cin):
        return w
    cout = _cout(w, cin)
    if w.dim() == 2:
        return w[:, :9 * cin].reshape(cout, 3, 3, cin)
    return w.permute(2, 1, 0, 3).reshape(cout, 3, 3, -1)[..., :cin]


def conv3x3_int8_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, out_scale: torch.Tensor,
                       relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K2 (``_QuantExec.double_conv``'s body)."""
    w = _natural(w, x.shape[3])
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
    if x.dim() != 4:
        raise ValueError(f"conv3x3_int8 takes x (N,H,W,Cin), got {tuple(x.shape)}")
    cin = x.shape[3]
    if w.dim() not in (2, 4) or not (_is_natural(w, cin)
                                     or tuple(w.shape) == _packed_shape(cin, _cout(w, cin))):
        raise ValueError(f"conv3x3_int8 takes w as (Cout,3,3,Cin) or packed by "
                         f"pack_weights, {_packed_shape(cin, 'Cout')} for Cin={cin}; "
                         f"got x {tuple(x.shape)} and w {tuple(w.shape)}")
    cout = _cout(w, cin)
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


def _launch(x, w, scale, bias, out_scale, relu):
    """K2 on CUDA tensors (see :func:`conv3x3_int8`)."""
    n, h, wd, cin = x.shape
    cout = _cout(w, cin)
    if cout % _COUT_MULTIPLE:
        if not _is_natural(w, cin):
            raise ValueError(f"conv3x3_int8 on CUDA takes packed weights with Cout % 16 "
                             f"== 0 (pad_cout before pack_weights), got {cout}")
        out = _launch(x, pad_cout(w), pad_cout(scale), pad_cout(bias), out_scale, relu)
        return out[..., :cout].contiguous()
    if _is_natural(w, cin):
        w = pack_weights(w, cin)
    first = cin == _FIRST_LAYER_CIN
    if not first:
        x = pad_channels(x)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3_int8 needs 16-byte aligned x and w on CUDA "
                         "(a view at an odd offset: pass a contiguous copy)")
    out = torch.empty((n, h, wd, cout), dtype=torch.int8, device=x.device)
    lib = build.load("conv3x3_int8")
    fn = lib.tpu_unet_conv3x3_int8_c3 if first else lib.tpu_unet_conv3x3_int8
    # The entry point sets the kernel's shared-memory attribute on, and
    # launches on, the current device: make it x's (a serving replica on
    # another GPU is called while the first one is current).
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 out_scale.data_ptr(), out.data_ptr(), n, h, wd, x.shape[3], cout,
                 int(relu), build.current_stream(x.device))
    build.check(lib, "conv3x3_int8", err)
    with build.LOCK:
        conv3x3_int8.launches += 1
    return out


@torch.library.custom_op("tpu_unet_torch::conv3x3_int8", mutates_args=())
def _conv3x3_int8_op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, out_scale: torch.Tensor, relu: bool) -> torch.Tensor:
    """The plain version for CPU tensors; the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return conv3x3_int8_plain(x, w, scale, bias, out_scale, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_int8 runs on cpu or cuda, not {x.device}")
    return _launch(x, w, scale, bias, out_scale, relu)


@_conv3x3_int8_op.register_fake
def _(x, w, scale, bias, out_scale, relu):
    n, h, wd, cin = x.shape
    return x.new_empty((n, h, wd, _cout(w, cin)))


def conv3x3_int8(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, out_scale: torch.Tensor,
                 relu: bool = True) -> torch.Tensor:
    """int8 (N, H, W, Cin) x weights -> requantized int8 (N, H, W, Cout).

    On CUDA, natural weights are packed here on every call (pack them once
    with :func:`pack_weights` where they serve many calls). Cin = 3 goes to
    the first-layer kernel, which reads the input as it is; any other Cin
    that is not a multiple of 32 is zero-padded here (one extra pass over x).
    Natural weights with Cout not a multiple of 16 are zero-padded here with
    their scale and bias, and the output sliced back (an extra copy); packed
    weights must come padded (:func:`pad_cout` before :func:`pack_weights`).
    """
    with span("kernel.k2"):
        _check(x, w, scale, bias, out_scale)
        return _conv3x3_int8_op(x, w, scale, bias, out_scale, relu)


conv3x3_int8.launches = 0
