"""Device input transforms (counterpart of ``tpu_unet/ops/augment.py``).

Images are NHWC, as in the JAX package: the host ships uint8 and the device
does the rest.

- ``eval_transform``: normalize, through kernel K1 (``ops/kernels/preprocess.py``)
  on CUDA tensors and its plain version on CPU tensors.
- ``train_transform``: to-float, paired geometry (one flip decision and one
  rotation per image, bilinear on the image, nearest on the mask), colour
  jitter, normalize. CUDA uint8 images under the shear rotation modes with
  the fixed jitter order take one hand-written pass
  (``ops/kernels/augment.py``, ``csrc/augment_u8.cu``); every other call
  (CPU tensors, the 4-corner 'per_sample' rotation, random-order jitter)
  takes :func:`train_transform_composed`, PyTorch ops in the order the JAX
  package computes them in plain XLA. :data:`COUNTERS` counts the two routes.
  Under 'per_sample_shear' both routes rotate by ``ops/rotate_shear.py``'s
  gathers (the composed route calls them, the kernel computes them); under
  'per_batch_shear' the composed route multiplies by its dense shear
  operators instead.

Randomness: the JAX package draws from keys inside its transforms. Here the
draws are an argument, an :class:`AugmentDraws` that
:func:`sample_augment_draws` makes on the device from a ``torch.Generator``,
so the same draws can be fed to both packages.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Optional, Tuple

import torch

from tpu_unet_torch.ops.rotate_shear import (rotate_batch_shear,
                                             rotate_batch_shear_per_sample)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# train_transform calls through the one-pass kernel and through the composed
# ops, since the last reset.
COUNTERS = {"fused": 0, "composed": 0}

# The 24 orders of (brightness, contrast, saturation, hue), indexed as the
# JAX package's lax.switch branches.
JITTER_ORDERS = tuple(itertools.permutations(range(4)))


def to_float(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]."""
    # A tensor divisor, not a Python number: on CUDA PyTorch multiplies by the
    # reciprocal of a scalar divisor, which differs from x / 255 in the last bit.
    return images_u8.to(torch.float32) / torch.full((1,), 255.0,
                                                    device=images_u8.device)


@functools.lru_cache(maxsize=32)
def device_constant(values: Tuple[float, ...], dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, made once: a copy from host
    memory to a GPU waits for the GPU to drain, so a train step must not
    make one per call. Callers must not write to it. Made outside inference
    mode, since a constant first made while serving may later enter a
    train step's autograd."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def normalize(images: torch.Tensor,
              mean: Tuple[float, ...] = IMAGENET_MEAN,
              std: Tuple[float, ...] = IMAGENET_STD) -> torch.Tensor:
    """(images - mean[c]) / std[c] over the last (channel) axis."""
    mean_t = device_constant(tuple(mean), images.dtype, images.device)
    std_t = device_constant(tuple(std), images.dtype, images.device)
    return (images - mean_t) / std_t


def eval_transform(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> normalized float32 NHWC (no augmentation), through K1."""
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8
    return normalize_u8(images_u8)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AugmentDraws:
    """The random draws of one ``train_transform`` call.

    Attributes:
      flip:  (N,) bool, flip image and mask horizontally.
      angle: rotation in degrees, 0-dim ('per_batch_shear') or (N,).
      fb, fc, fs: (N, 1, 1, 1) brightness, contrast and saturation factors.
      fh:    (N, 1, 1) hue shift.
      perm:  index into :data:`JITTER_ORDERS` (used under random order only).
    """

    flip: torch.Tensor
    angle: torch.Tensor
    fb: torch.Tensor
    fc: torch.Tensor
    fs: torch.Tensor
    fh: torch.Tensor
    perm: int = 0

    def to(self, device) -> "AugmentDraws":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "perm"})


def sample_augment_draws(n: int, cfg, generator: torch.Generator) -> AugmentDraws:
    """Draws for a batch of ``n`` under ``cfg`` (an ``AugmentConfig``), made on
    the generator's device with the JAX package's distributions: flip with
    probability ``p_flip``, angles uniform in [-degrees, degrees] (one per
    batch under 'per_batch_shear'), factors uniform in [1 - x, 1 + x], hue
    shift uniform in [-hue, hue], one jitter order of 24 per batch. Under
    random order the order index is read back to the host."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    d = cfg.degrees
    angle_shape = () if cfg.rotation_mode == "per_batch_shear" else (n,)
    perm = 0
    if cfg.color_jitter_random_order:
        perm = int(torch.randint(len(JITTER_ORDERS), (), generator=generator, device=dev))
    return AugmentDraws(
        flip=torch.rand(n, generator=generator, device=dev) < cfg.p_flip,
        angle=uniform(angle_shape, -d, d),
        fb=uniform((n, 1, 1, 1), 1 - cfg.brightness, 1 + cfg.brightness),
        fc=uniform((n, 1, 1, 1), 1 - cfg.contrast, 1 + cfg.contrast),
        fs=uniform((n, 1, 1, 1), 1 - cfg.saturation, 1 + cfg.saturation),
        fh=uniform((n, 1, 1), -cfg.hue, cfg.hue),
        perm=perm)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def rotate_batch(images: torch.Tensor, angles_deg: torch.Tensor,
                 order: int = 1) -> torch.Tensor:
    """Per-image CCW rotation of an NHWC batch ((N,) degrees): one flat gather
    per bilinear corner over the whole batch (indices b*H*W + y*W + x).
    Out-of-bounds corners are clipped into the image and weighted 0."""
    n, h, w, c = images.shape
    dev = images.device
    theta = torch.deg2rad(angles_deg.to(torch.float32))
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[None, :, None]
    xx = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, None, :]
    # Inverse map (CCW, like scipy and torchvision), per image: (N, H*W).
    src_y = (cos * yy + sin * xx + cy).reshape(n, -1)
    src_x = (-sin * yy + cos * xx + cx).reshape(n, -1)

    flat = images.reshape(n * h * w, c)
    base = (torch.arange(n, dtype=torch.int64, device=dev) * (h * w))[:, None]

    def corner(yi, xi, weight):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = base + torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        sample = flat.index_select(0, idx.reshape(-1))
        wgt = (weight * valid.to(images.dtype)).reshape(-1)
        return sample * wgt[:, None]

    if order == 0:
        yi = torch.round(src_y).to(torch.int64)
        xi = torch.round(src_x).to(torch.int64)
        out = corner(yi, xi, torch.ones_like(src_y, dtype=images.dtype))
    else:
        y0 = torch.floor(src_y)
        x0 = torch.floor(src_x)
        fy = (src_y - y0).to(images.dtype)
        fx = (src_x - x0).to(images.dtype)
        y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
        out = (corner(y0, x0, (1 - fy) * (1 - fx))
               + corner(y0, x0 + 1, (1 - fy) * fx)
               + corner(y0 + 1, x0, fy * (1 - fx))
               + corner(y0 + 1, x0 + 1, fy * fx))
    return out.reshape(n, h, w, c)


def paired_geometric_augment(images: torch.Tensor, masks: Optional[torch.Tensor],
                             draws: AugmentDraws, *, degrees: float = 10.0,
                             rotation_mode: str = "per_sample"
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Horizontal flip and rotation, the same geometry for image and mask.

    The image is sampled bilinearly, the mask by nearest neighbour; a mask is
    flipped and rotated as float32 and cast back to its own dtype (uint8
    masks stay uint8).

    rotation_mode: 'per_sample' (one angle per image, the 4-corner gather:
    the reference's torchvision semantics), 'per_sample_shear' (one angle per
    image, three cropped shears as gathers) or 'per_batch_shear' (one angle
    for the batch, three shear matmuls).
    """
    flip = draws.flip[:, None, None, None]
    out_img = torch.where(flip, images.flip(2), images)
    m = None
    if masks is not None:
        m = masks.to(torch.float32)
        m = torch.where(flip, m.flip(2), m)

    if degrees > 0:
        if rotation_mode == "per_batch_shear":
            rot = functools.partial(rotate_batch_shear, max_degrees=degrees)
        elif rotation_mode == "per_sample_shear":
            rot = rotate_batch_shear_per_sample
        elif rotation_mode == "per_sample":
            rot = rotate_batch
        else:
            raise ValueError(f"Unknown rotation_mode: {rotation_mode!r}")
        out_img = rot(out_img, draws.angle, order=1)
        if m is not None:
            m = rot(m, draws.angle, order=0)

    out_mask = m.to(masks.dtype) if m is not None else None
    return out_img, out_mask


# ---------------------------------------------------------------------------
# Photometry (image only)
# ---------------------------------------------------------------------------

def _rgb_to_gray(images: torch.Tensor) -> torch.Tensor:
    w = device_constant((0.299, 0.587, 0.114), images.dtype, images.device)
    return torch.sum(images * w, dim=-1, keepdim=True)


def _rgb_to_hsv(images: torch.Tensor):
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    maxc = images.amax(dim=-1)
    minc = images.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros((), dtype=images.dtype, device=images.device)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe_delta = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return h, s, v


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int64), 6)[..., None]
    r = torch.stack([v, q, p, p, t, v], dim=-1).gather(-1, i)
    g = torch.stack([t, v, v, q, p, p], dim=-1).gather(-1, i)
    b = torch.stack([p, p, t, v, v, q], dim=-1).gather(-1, i)
    return torch.cat([r, g, b], dim=-1)


def color_jitter(images: torch.Tensor, draws: AugmentDraws, *,
                 brightness: float = 0.1, contrast: float = 0.1,
                 saturation: float = 0.1, hue: float = 0.05,
                 random_order: bool = False) -> torch.Tensor:
    """Per-image brightness, contrast, saturation and hue jitter with the
    factors of ``draws``. The order is brightness, contrast, saturation, hue,
    or under ``random_order`` the batch's order ``JITTER_ORDERS[draws.perm]``
    (torchvision's ColorJitter draws one per call). An op whose strength is 0
    is skipped."""
    fb, fc, fs, fh = draws.fb, draws.fc, draws.fs, draws.fh

    def op_brightness(x):
        return torch.clamp(x * fb, 0.0, 1.0) if brightness > 0 else x

    def op_contrast(x):
        if contrast <= 0:
            return x
        mean = torch.mean(_rgb_to_gray(x), dim=(1, 2), keepdim=True)
        return torch.clamp(fc * x + (1 - fc) * mean, 0.0, 1.0)

    def op_saturation(x):
        if saturation <= 0:
            return x
        return torch.clamp(fs * x + (1 - fs) * _rgb_to_gray(x), 0.0, 1.0)

    def op_hue(x):
        if hue <= 0:
            return x
        h, s, v = _rgb_to_hsv(x)
        return _hsv_to_rgb(torch.remainder(h + fh, 1.0), s, v)

    ops = (op_brightness, op_contrast, op_saturation, op_hue)
    x = images
    for j in (JITTER_ORDERS[draws.perm] if random_order else range(4)):
        x = ops[j](x)
    return x


# ---------------------------------------------------------------------------
# The train transform
# ---------------------------------------------------------------------------

def train_transform(images_u8: torch.Tensor, masks: Optional[torch.Tensor],
                    draws: AugmentDraws, *, degrees: float = 10.0,
                    brightness: float = 0.1, contrast: float = 0.1,
                    saturation: float = 0.1, hue: float = 0.05,
                    rotation_mode: str = "per_sample",
                    color_jitter_random_order: bool = False):
    """uint8 NHWC -> augmented, normalized float32 NHWC, and the paired mask
    in its own dtype: through the one-pass kernel where it takes the call,
    else through :func:`train_transform_composed`."""
    from tpu_unet_torch.ops.kernels import augment as fused
    route = ("fused" if fused.takes(images_u8, masks, rotation_mode, color_jitter_random_order)
             else "composed")
    COUNTERS[route] += 1
    kw = dict(degrees=degrees, brightness=brightness, contrast=contrast,
              saturation=saturation, hue=hue, rotation_mode=rotation_mode)
    if route == "fused":
        return fused.augment_u8(images_u8, masks, draws, **kw)
    return train_transform_composed(images_u8, masks, draws, **kw,
                                    color_jitter_random_order=color_jitter_random_order)


def train_transform_composed(images_u8: torch.Tensor, masks: Optional[torch.Tensor],
                             draws: AugmentDraws, *, degrees: float = 10.0,
                             brightness: float = 0.1, contrast: float = 0.1,
                             saturation: float = 0.1, hue: float = 0.05,
                             rotation_mode: str = "per_sample",
                             color_jitter_random_order: bool = False):
    """:func:`train_transform` as PyTorch ops, on any device and in every mode."""
    img = to_float(images_u8)
    img, masks = paired_geometric_augment(img, masks, draws, degrees=degrees,
                                          rotation_mode=rotation_mode)
    img = color_jitter(img, draws, brightness=brightness, contrast=contrast,
                       saturation=saturation, hue=hue,
                       random_order=color_jitter_random_order)
    return normalize(img), masks
