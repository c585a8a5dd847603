"""The train augment in one hand-written pass (``csrc/augment_u8.cu``).

``ops/augment.py::train_transform`` takes this route for CUDA uint8 NHWC
images under the shear rotation modes without random-order jitter (see
:func:`takes`): uint8 images to the flipped, rotated, colour-jittered and
normalized float32 NHWC batch, with the paired mask (uint8 or float32) moved
by the same geometry, in one kernel, or two when contrast is on.

The rotation is the three cropped shears of
``ops/rotate_shear.py::rotate_batch_shear_per_sample``: an output pixel's
value is 8 taps a channel of the uint8 source through the three stages, a
mask value one tap a stage at the shift rounded half to even. Contrast needs
each image's mean gray value: the first kernel writes a partial sum per
block of :data:`BLOCK_PIXELS` pixels, the second sums an image's partials in
a fixed order and applies the rest of the jitter and normalize in place.

It replaces no TPU kernel: the JAX package computes this augment in plain
XLA. :func:`augment_u8_plain` is the kernel's algorithm in plain PyTorch
(its gathers, rounding and two-pass contrast), which the tests hold to the
composed ``train_transform`` on the CPU. The wrapper :func:`augment_u8`
runs the plain version for CPU tensors and the kernel for CUDA tensors,
through the operator ``torch.ops.tpu_unet_torch.augment_u8`` (a
``torch.library`` custom op with a fake implementation);
``augment_u8.launches`` counts kernel launches: two a call with contrast
(geometry and jitter), one without. Each call of the wrapper is one
``kernel.augment`` span (``utils/spans.py``), on either device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_unet_torch.ops import rotate_shear
from tpu_unet_torch.ops.augment import (IMAGENET_MEAN, IMAGENET_STD, AugmentDraws,
                                        _hsv_to_rgb, _rgb_to_gray, _rgb_to_hsv, normalize,
                                        to_float)
from tpu_unet_torch.ops.kernels import build
from tpu_unet_torch.utils.spans import span

# Pixels of one image a block of the geometry kernel takes: one partial sum of
# the gray value each (csrc/augment_u8.cu's kPix).
BLOCK_PIXELS = 1024

ROTATION_MODES = ("per_batch_shear", "per_sample_shear")
_MASK_DTYPES = (torch.uint8, torch.float32)


def takes(images_u8: torch.Tensor, masks: Optional[torch.Tensor], rotation_mode: str,
          random_order: bool) -> bool:
    """Whether ``train_transform`` takes the kernel for this call: CUDA uint8
    (N, H, W, 3) images, no mask or a uint8 or float32 one of the same
    (N, H, W) on the same device, a shear rotation mode and the fixed jitter
    order."""
    if not (images_u8.is_cuda and images_u8.dtype == torch.uint8 and images_u8.dim() == 4
            and images_u8.shape[-1] == 3):
        return False
    if masks is not None and not (masks.dtype in _MASK_DTYPES and masks.device == images_u8.device
                                  and masks.dim() == 4
                                  and masks.shape[:3] == images_u8.shape[:3]):
        return False
    return rotation_mode in ROTATION_MODES and not random_order


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def augment_u8_plain(images_u8: torch.Tensor, masks: Optional[torch.Tensor],
                     draws: AugmentDraws, *, degrees: float = 10.0,
                     brightness: float = 0.1, contrast: float = 0.1,
                     saturation: float = 0.1, hue: float = 0.05,
                     rotation_mode: str = "per_batch_shear"
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's algorithm in plain PyTorch (see the module docstring);
    ``rotation_mode`` is the draws' business: one angle, or one per image."""
    n, h, w, _ = images_u8.shape
    flip = draws.flip[:, None, None, None]
    x = to_float(images_u8)
    x = torch.where(flip, x.flip(2), x)
    m = None if masks is None else torch.where(flip, masks.flip(2), masks)
    if degrees > 0:
        x = rotate_shear.rotate_batch_shear_per_sample(x, draws.angle, order=1)
        if m is not None:
            m = rotate_shear.rotate_batch_shear_per_sample(m, draws.angle, order=0)
    if brightness > 0:
        x = torch.clamp(x * draws.fb, 0.0, 1.0)
    if contrast > 0:
        # A partial sum per block of BLOCK_PIXELS pixels, then their sum.
        gray = _rgb_to_gray(x).reshape(n, h * w)
        gray = torch.nn.functional.pad(gray, (0, -(h * w) % BLOCK_PIXELS))
        total = gray.reshape(n, -1, BLOCK_PIXELS).sum(-1).sum(-1)
        mean = (total / (h * w)).reshape(n, 1, 1, 1)
        x = torch.clamp(draws.fc * x + (1 - draws.fc) * mean, 0.0, 1.0)
    if saturation > 0:
        x = torch.clamp(draws.fs * x + (1 - draws.fs) * _rgb_to_gray(x), 0.0, 1.0)
    if hue > 0:
        hh, s, v = _rgb_to_hsv(x)
        x = _hsv_to_rgb(torch.remainder(hh + draws.fh, 1.0), s, v)
    return normalize(x), m


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------

def _check(images_u8, masks, draws, rotation_mode) -> None:
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"augment_u8 takes uint8 images, got {images_u8.dtype}")
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"augment_u8 takes (N, H, W, 3) images, got {tuple(images_u8.shape)}")
    n = images_u8.shape[0]
    if masks is not None:
        if masks.dtype not in _MASK_DTYPES:
            raise TypeError(f"augment_u8 takes a uint8 or float32 mask, got {masks.dtype}")
        if masks.dim() != 4 or masks.shape[:3] != images_u8.shape[:3]:
            raise ValueError(f"augment_u8 takes a mask (N, H, W, C) of the images' (N, H, W) "
                             f"{tuple(images_u8.shape[:3])}, got {tuple(masks.shape)}")
        if masks.device != images_u8.device:
            raise ValueError(f"the mask is on {masks.device}, the images on {images_u8.device}")
    if rotation_mode not in ROTATION_MODES:
        raise ValueError(f"augment_u8 takes rotation_mode {' or '.join(ROTATION_MODES)}, got "
                         f"{rotation_mode!r}")
    want = () if rotation_mode == "per_batch_shear" else (n,)
    if tuple(draws.angle.shape) != want:
        raise ValueError(f"rotation_mode {rotation_mode!r} takes an angle of shape {want}, got "
                         f"{tuple(draws.angle.shape)}")
    if draws.flip.dtype != torch.bool or tuple(draws.flip.shape) != (n,):
        raise ValueError(f"flip must be ({n},) bool, got {draws.flip.dtype} "
                         f"{tuple(draws.flip.shape)}")
    for name in ("fb", "fc", "fs", "fh"):
        t = getattr(draws, name)
        if t.dtype != torch.float32 or t.numel() != n or t.shape[0] != n:
            raise ValueError(f"{name} must be float32 with {n} values, one per image, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name in ("flip", "angle", "fb", "fc", "fs", "fh"):
        if getattr(draws, name).device != images_u8.device:
            raise ValueError(f"draws.{name} is on {getattr(draws, name).device}, the images on "
                             f"{images_u8.device}")


def _launch(images_u8, masks, flip, angle, fb, fc, fs, fh, degrees, brightness, contrast,
            saturation, hue):
    """The kernel on CUDA tensors (see :func:`augment_u8`)."""
    n, h, w, _ = images_u8.shape
    dev = images_u8.device
    lib = build.load("augment_u8")
    if lib.tpu_unet_augment_u8_block_pixels() != BLOCK_PIXELS:
        raise RuntimeError("augment_u8.cu's block differs from BLOCK_PIXELS")
    src = images_u8.contiguous()
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=dev)
    rotate = degrees > 0
    if rotate:
        a, b = (t.contiguous() for t in rotate_shear.shear_coefficients(angle))
    else:
        a = b = out  # not read
    per = [t.reshape(n).contiguous() for t in (fb, fc, fs, fh)]
    partials = (torch.empty(n * (-(-h * w // BLOCK_PIXELS)), dtype=torch.float32, device=dev)
                if contrast > 0 else out)
    if masks is None:
        m_in = m_out = None
        mask_c = 0
    else:
        m_in = masks.contiguous()
        m_out = torch.empty_like(m_in)
        mask_c = masks.shape[3]
    flip = flip.contiguous()
    with torch.cuda.device(dev):
        err = lib.tpu_unet_augment_u8(
            src.data_ptr(), flip.data_ptr(), a.data_ptr(), b.data_ptr(), int(a.dim() == 1),
            *(t.data_ptr() for t in per),
            None if m_in is None else m_in.data_ptr(),
            None if m_out is None else m_out.data_ptr(), mask_c,
            int(masks is not None and masks.dtype == torch.float32),
            out.data_ptr(), partials.data_ptr(), n, h, w, int(rotate), int(brightness > 0),
            int(contrast > 0), int(saturation > 0), int(hue > 0), *IMAGENET_MEAN, *IMAGENET_STD,
            build.current_stream(dev))
    build.check(lib, "augment_u8", err)
    with build.LOCK:
        augment_u8.launches += 1 + (contrast > 0)
    return out, (m_out if m_out is not None else out.new_empty(0))


@torch.library.custom_op("tpu_unet_torch::augment_u8", mutates_args=())
def _augment_u8_op(images_u8: torch.Tensor, masks: Optional[torch.Tensor], flip: torch.Tensor,
                   angle: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor, fs: torch.Tensor,
                   fh: torch.Tensor, degrees: float, brightness: float, contrast: float,
                   saturation: float, hue: float, per_sample: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version for CPU tensors; the kernel for CUDA tensors. With
    no mask the second output is empty."""
    if images_u8.device.type == "cpu":
        draws = AugmentDraws(flip=flip, angle=angle, fb=fb, fc=fc, fs=fs, fh=fh)
        img, m = augment_u8_plain(
            images_u8, masks, draws, degrees=degrees, brightness=brightness, contrast=contrast,
            saturation=saturation, hue=hue,
            rotation_mode=ROTATION_MODES[int(per_sample)])
        return img, (m if m is not None else img.new_empty(0))
    if images_u8.device.type != "cuda":
        raise ValueError(f"augment_u8 runs on cpu or cuda, not {images_u8.device}")
    return _launch(images_u8, masks, flip, angle, fb, fc, fs, fh, degrees, brightness, contrast,
                   saturation, hue)


@_augment_u8_op.register_fake
def _(images_u8, masks, flip, angle, fb, fc, fs, fh, degrees, brightness, contrast,
      saturation, hue, per_sample):
    out = images_u8.new_empty(images_u8.shape, dtype=torch.float32)
    return out, (masks.new_empty(masks.shape) if masks is not None else out.new_empty(0))


def augment_u8(images_u8: torch.Tensor, masks: Optional[torch.Tensor], draws: AugmentDraws, *,
               degrees: float = 10.0, brightness: float = 0.1, contrast: float = 0.1,
               saturation: float = 0.1, hue: float = 0.05,
               rotation_mode: str = "per_batch_shear"
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """uint8 (N, H, W, 3) images and their (N, H, W, C) mask -> the augmented,
    normalized float32 images and the mask moved with them, in its dtype."""
    with span("kernel.augment"):
        _check(images_u8, masks, draws, rotation_mode)
        img, m = _augment_u8_op(images_u8, masks, draws.flip, draws.angle, draws.fb, draws.fc,
                                draws.fs, draws.fh, float(degrees), float(brightness),
                                float(contrast), float(saturation), float(hue),
                                rotation_mode == "per_sample_shear")
        return img, (m if masks is not None else None)


augment_u8.launches = 0
