"""Tiled native-resolution inference (counterpart of ``tpu_unet/ops/tiling.py``).

A model trained at one shape serves images larger than it: a static grid of
overlapping tiles is cut from each image, every tile of every image runs
through the model as one batch, and the tile logits blend back at full
resolution with a separable triangular window.

The blend is the JAX package's, operation for operation, so float32 results
agree with it to the ulp: tiles are stacked tile-major into the batch, then
``num += w * logits`` accumulates in float32, adding the tiles in grid
order, and ``num`` is multiplied by a precomputed ``inv_den`` (numpy float32,
made as the JAX package makes it). That blend returns a pixel covered by one
tile within an ulp of the tile's logit (``w * l * (1 / w)``), so a grid of
one tile, the whole image, skips it: the tiled forward then equals the
untiled one exactly. The window and ``inv_den`` are kept per device.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

__all__ = ["tile_offsets", "tile_weight", "make_tiled_logits_fn"]


def tile_offsets(extent: int, tile: int, stride: int) -> Tuple[int, ...]:
    """Tile start offsets covering ``[0, extent)``: every ``stride``, and
    the last tile shifted back to end exactly at ``extent``."""
    extent, tile, stride = int(extent), int(tile), int(stride)
    if tile > extent:
        raise ValueError(f"tile ({tile}) larger than image extent ({extent})")
    if stride <= 0:
        raise ValueError(f"stride must be positive (got {stride}; is the "
                         "overlap >= the tile size?)")
    if tile == extent:
        return (0,)
    offs = list(range(0, extent - tile, stride))
    offs.append(extent - tile)
    return tuple(offs)


def tile_weight(tile_h: int, tile_w: int) -> np.ndarray:
    """(th, tw) float32 separable triangular blend window, peaking at the
    tile's center and clamped to at least 1e-3, so the accumulated weight
    never vanishes at a tile corner."""
    def ramp(n: int) -> np.ndarray:
        x = (np.arange(n, dtype=np.float32) + 0.5) / n  # pixel centers in (0,1)
        return 2.0 * np.minimum(x, 1.0 - x)

    w = np.outer(ramp(int(tile_h)), ramp(int(tile_w)))
    return np.maximum(w, 1e-3).astype(np.float32)


def _grid(image_hw, tile_hw, overlap):
    h, w = image_hw
    th, tw = tile_hw
    ys = tile_offsets(h, th, th - overlap)
    xs = tile_offsets(w, tw, tw - overlap)
    return [(oy, ox) for oy in ys for ox in xs]


@functools.lru_cache(maxsize=16)
def _blend_constants(image_hw, tile_hw, overlap, device):
    """The (1, th, tw, 1) window and the (1, H, W, 1) ``inv_den`` on ``device``."""
    (h, w), (th, tw) = image_hw, tile_hw
    w_np = tile_weight(th, tw)
    den = np.zeros((h, w), np.float32)
    for oy, ox in _grid(image_hw, tile_hw, overlap):
        den[oy:oy + th, ox:ox + tw] += w_np
    inv_den = (1.0 / den).astype(np.float32)
    return (torch.from_numpy(w_np)[None, :, :, None].to(device),
            torch.from_numpy(inv_den)[None, :, :, None].to(device))


def make_tiled_logits_fn(tile_apply: Callable, image_hw: Sequence[int],
                         tile_hw: Sequence[int], overlap: int = 64) -> Callable:
    """Build ``fn(images_u8 (N, H, W, 3)) -> (N, H, W, C) float32 logits``.

    ``tile_apply(tiles_u8 (M, th, tw, 3)) -> (M, th, tw, C)`` is the tile
    forward (float, int8, a UNet++ head). ``fn`` cuts the static grid out of
    each image, runs all N * n_tiles tiles as one batch (tile-major: rows
    ``i*N:(i+1)*N`` are grid[i]'s tiles) and blends them back.
    """
    image_hw = tuple(int(x) for x in image_hw)
    tile_hw = tuple(int(x) for x in tile_hw)
    overlap = int(overlap)
    if overlap < 0:
        raise ValueError(f"overlap must be >= 0 (got {overlap})")
    (h, w), (th, tw) = image_hw, tile_hw
    grid = _grid(image_hw, tile_hw, overlap)
    if tile_hw == image_hw:  # one tile
        return lambda images_u8: tile_apply(images_u8).to(torch.float32)

    def fn(images_u8: torch.Tensor) -> torch.Tensor:
        n = images_u8.shape[0]
        tiles = torch.cat([images_u8[:, oy:oy + th, ox:ox + tw, :] for oy, ox in grid])
        logits = tile_apply(tiles)
        wt, inv_den = _blend_constants(image_hw, tile_hw, overlap, images_u8.device)
        num = torch.zeros((n, h, w, logits.shape[-1]), dtype=torch.float32,
                          device=images_u8.device)
        for i, (oy, ox) in enumerate(grid):
            num[:, oy:oy + th, ox:ox + tw, :] += logits[i * n:(i + 1) * n].to(torch.float32) * wt
        return num * inv_den

    return fn
