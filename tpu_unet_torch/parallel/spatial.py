"""The 'space' axis: activations sharded over the image's rows, with the
halo exchanges a 3x3 conv and a row resize need (the port's counterpart of
what GSPMD inserts for the JAX package's ``P('data', 'space')`` batches).

Each of the ``n`` ranks of a space group holds a block of ``h = H / n``
consecutive rows of every activation. An :class:`Exchanger` moves rows
between them:

- :class:`GroupExchanger`: the space ranks of a ``torch.distributed``
  process group (training, the evaluators). Its exchange is one
  ``all_gather`` of each rank's (first, last) rows over the group, which
  gloo and NCCL both run on CUDA and CPU tensors alike;
- :class:`ThreadExchanger`: threads of one process (serving), one per space
  device, meeting at a barrier to read each other's rows. A CUDA producer
  records an event on its stream, and the reader's stream waits for it.

Inside :func:`scope` of an exchanger the model's operations run on the
rank's rows: ``models/blocks.py::conv_bn`` pads its 3x3 conv with
:func:`halo_rows`, ``ops/resize.py`` resizes rows through
:func:`resize_rows`, and the int8 executor (``ops/quantize.py``) halos K2's
input. Everything else the models do (max-pool, the k2s2 transposed conv,
1x1 convs, the gate's stride 2, dropout) needs no rows of a neighbour,
provided every level's block of rows is even: :func:`check_rows` holds the
image height to ``H % (n * 2**depth) == 0``.

Gradients follow the convention of ``losses/reduction.py``: the mean of
the ranks' gradients is the global gradient. A halo row's gradient goes
back to the rank the row came from; :func:`space_sum` (the Dice sums over
an image's rows) all-reduces in both directions; :func:`split_rows` gives a
replicated input's gradient the rank's rows only.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEPTH = 4  # the models' max-pool levels: the bottleneck is H / 16 rows
UNEVEN = ("heights whose deeper levels do not split evenly over the 'space' ranks "
          "are the last item of ROADMAP queue 1")

# Exchanges made and bytes this rank contributed to them, since the last reset.
COUNTERS = {"exchanges": 0, "bytes": 0}

_STATE = threading.local()


def current() -> Optional["Exchanger"]:
    """The exchanger of this thread's :func:`scope` (None outside one)."""
    return getattr(_STATE, "exchanger", None)


@contextlib.contextmanager
def scope(exchanger: Optional["Exchanger"]):
    """Run the models' row operations on this rank's rows through
    ``exchanger`` (None: whole images) inside the ``with`` block, in this
    thread."""
    before = current()
    _STATE.exchanger = exchanger
    try:
        yield exchanger
    finally:
        _STATE.exchanger = before


def check_rows(height: int, n_space: int, depth: int = DEPTH) -> None:
    """ValueError unless ``height`` rows split over ``n_space`` ranks at
    every one of the models' ``depth`` levels: the JAX package's condition
    (``n_space`` divides the height), then the port's, ``height % (n_space
    * 2**depth) == 0``."""
    if n_space <= 1:
        return
    if height % n_space:
        raise ValueError(f"--n_space {n_space} must divide the image height {height}")
    if height % (n_space * 2 ** depth):
        raise ValueError(
            f"--n_space {n_space}: the image height {height} must be a multiple of "
            f"n_space x 2^{depth} = {n_space * 2 ** depth}, so that every level's rows "
            f"split evenly over the ranks; {UNEVEN}")


class Exchanger:
    """The rows of the other ranks of one space group: ``index`` of
    ``size``. Subclasses give :meth:`all_gather`; :class:`GroupExchanger`
    also the ``all_reduce`` that training's backward needs."""

    index: int
    size: int

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape on all), in rank order, on ``t``'s device."""
        raise NotImplementedError

    def neighbours(self, top: torch.Tensor, bottom: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(above, below)``: the previous rank's ``bottom`` and the next
        rank's ``top`` (zeros past the image's first and last rows)."""
        edges = torch.stack([top, bottom]).contiguous()
        COUNTERS["exchanges"] += 1
        COUNTERS["bytes"] += edges.numel() * edges.element_size()
        parts = self.all_gather(edges)
        i = self.index
        above = parts[i - 1][1] if i > 0 else torch.zeros_like(top)
        below = parts[i + 1][0] if i + 1 < self.size else torch.zeros_like(bottom)
        return above, below


class GroupExchanger(Exchanger):
    """The space ranks of a process group (``parallel/mesh.py::space_group``)."""

    def __init__(self, group):
        self.group = group
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return parts

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, the same on all of them (the
        backward of a train step's gathers and sums; serving needs none)."""
        out = t.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out


def mesh_exchanger(mesh) -> Optional[GroupExchanger]:
    """The exchanger of this rank's space group on ``mesh`` (the mesh
    ``make_mesh`` built last); None without a mesh or a 'space' axis wider
    than 1."""
    from tpu_unet_torch.parallel.mesh import space_group, space_size

    if mesh is None or space_size() == 1:
        return None
    return GroupExchanger(space_group())


class ThreadRing:
    """The meeting point of ``size`` threads that split one batch's rows
    (serving): :meth:`exchanger` gives thread ``i`` its exchanger. A thread
    that fails calls :meth:`abort`, so the others raise instead of waiting."""

    def __init__(self, size: int, timeout: float = 600.0):
        self.size = size
        self.slots: List = [None] * size
        self.barrier = threading.Barrier(size, timeout=timeout)

    def exchanger(self, index: int) -> "ThreadExchanger":
        return ThreadExchanger(self, index)

    def abort(self) -> None:
        self.barrier.abort()


class ThreadExchanger(Exchanger):
    """Thread ``index`` of a :class:`ThreadRing`: it publishes its tensor
    (with an event on its CUDA stream), waits for the others, copies theirs
    on its own stream after their events, and waits again, so that no slot
    is overwritten before every thread has read it."""

    def __init__(self, ring: ThreadRing, index: int):
        self.ring, self.index, self.size = ring, index, ring.size

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        t = t.contiguous()
        event = None
        if t.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
        self.ring.slots[self.index] = (t, event)
        self.ring.barrier.wait()
        out = []
        for j, (u, ev) in enumerate(self.ring.slots):
            if j == self.index:
                out.append(t)
                continue
            if ev is not None:
                if u.device == t.device:
                    stream = torch.cuda.current_stream(t.device)
                    stream.wait_event(ev)
                    u.record_stream(stream)  # the producer's memory outlives the copy
                else:
                    ev.synchronize()
            out.append(u.to(t.device, copy=True))
        self.ring.barrier.wait()
        return out


# ---------------------------------------------------------------------------
# Rows: halos, blocks, sums
# ---------------------------------------------------------------------------

def _format(x: torch.Tensor) -> torch.memory_format:
    """channels_last for a 4-d NCHW tensor laid out NHWC, else contiguous
    (the int8 path's NHWC tensors)."""
    if x.dim() == 4 and x.shape[1] > 1 and x.stride(1) == 1:
        return torch.channels_last
    return torch.contiguous_format


def _cat_rows(parts: List[torch.Tensor], dim: int, fmt) -> torch.Tensor:
    """``torch.cat(parts, dim)`` into one new tensor of memory format ``fmt``."""
    shape = list(parts[0].shape)
    shape[dim] = sum(p.shape[dim] for p in parts)
    out = torch.empty(shape, dtype=parts[0].dtype, device=parts[0].device,
                      memory_format=fmt)
    at = 0
    for p in parts:
        out.narrow(dim, at, p.shape[dim]).copy_(p)
        at += p.shape[dim]
    return out


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, dim):
        ctx.ex, ctx.dim = ex, dim
        h = x.shape[dim]
        above, below = ex.neighbours(x.narrow(dim, 0, 1), x.narrow(dim, h - 1, 1))
        return _cat_rows([above, x, below], dim, _format(x))

    @staticmethod
    def backward(ctx, g):
        dim, h = ctx.dim, g.shape[ctx.dim] - 2
        # The halo rows' gradients go back to the ranks the rows came from:
        # the previous rank's lower halo is this rank's first row, the next
        # rank's upper halo its last.
        from_prev, from_next = ctx.ex.neighbours(g.narrow(dim, 0, 1),
                                                 g.narrow(dim, h + 1, 1))
        dx = _cat_rows([g.narrow(dim, 1, h)], dim, _format(g))
        dx.narrow(dim, 0, 1).add_(from_prev)
        dx.narrow(dim, h - 1, 1).add_(from_next)
        return dx, None, None


def halo_rows(x: torch.Tensor, ex: Exchanger, dim: int = 2) -> torch.Tensor:
    """``x`` (this rank's rows on ``dim``) with one row above and one below
    from the neighbouring ranks, zeros at the image's first and last rows:
    what a 3x3 conv's padding needs. A new tensor in ``x``'s memory format.
    The backward adds the halo rows' gradients to the neighbours' edge rows."""
    return _Halo.apply(x, ex, dim)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, dim):
        ctx.ex, ctx.dim, ctx.shape = ex, dim, x.shape
        h = x.shape[dim] // ex.size
        return _cat_rows([x.narrow(dim, ex.index * h, h)], dim, _format(x))

    @staticmethod
    def backward(ctx, g):
        dx = g.new_zeros(ctx.shape)
        h = g.shape[ctx.dim]
        dx.narrow(ctx.dim, ctx.ex.index * h, h).copy_(g)
        return dx, None, None


def split_rows(x: torch.Tensor, ex: Optional[Exchanger], dim: int = 1) -> torch.Tensor:
    """This rank's block of ``x``'s rows on ``dim`` (a new tensor); ``x``
    without an exchanger. The backward gives the replicated input the
    gradient of the rank's rows only: the mean over the ranks is the whole
    gradient."""
    if ex is None:
        return x
    if x.shape[dim] % ex.size:
        raise ValueError(f"{x.shape[dim]} rows do not split over {ex.size} space ranks")
    return _Split.apply(x, ex, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, dim):
        ctx.ex, ctx.dim = ex, dim
        return _cat_rows(ex.all_gather(x), dim, _format(x))

    @staticmethod
    def backward(ctx, g):
        h = g.shape[ctx.dim] // ctx.ex.size
        total = ctx.ex.all_reduce(g)
        return total.narrow(ctx.dim, ctx.ex.index * h, h).clone(), None, None


def gather_rows(x: torch.Tensor, ex: Optional[Exchanger], dim: int = 1) -> torch.Tensor:
    """The whole image's rows on ``dim`` from every rank's block, on every
    rank (:func:`split_rows`' inverse); ``x`` without an exchanger."""
    if ex is None:
        return x
    return _Gather.apply(x, ex, dim)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex):
        ctx.ex = ex
        return ex.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ex.all_reduce(g), None


def space_sum(x: torch.Tensor, ex: Optional[Exchanger]) -> torch.Tensor:
    """The sum of ``x`` over the space ranks (e.g. per-image sums over
    their rows), differentiable: the backward all-reduces too, since every
    rank's loss reads the sum (``losses/segmentation.py``). ``x`` without
    an exchanger."""
    if ex is None:
        return x
    return _Sum.apply(x, ex)


# ---------------------------------------------------------------------------
# The align-corners row resize on a rank's rows
# ---------------------------------------------------------------------------

_MATRICES: Dict[Tuple, torch.Tensor] = {}


def _row_matrix(in_total: int, out_total: int, index: int, in_rows: int, out_rows: int,
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Rows ``[index out_rows, (index + 1) out_rows)`` of the global
    ``(out_total, in_total)`` align-corners matrix, restricted to the columns
    of the rank's ``in_rows`` rows plus one halo row on each side (zero
    columns past the image's edges): float64 -> float32 -> ``dtype``, as
    ``ops/resize.py::interp_matrix``. Kept per (global in, global out, rank
    rows, dtype, device)."""
    key = (in_total, out_total, index * out_rows, out_rows, dtype, torch.device(device))
    m = _MATRICES.get(key)
    if m is None:
        from tpu_unet_torch.ops.resize import _interp_matrix, kept_constant

        whole = _interp_matrix(in_total, out_total)[index * out_rows:(index + 1) * out_rows]
        lo = index * in_rows - 1
        window = np.zeros((out_rows, in_rows + 2), np.float64)
        cols = np.arange(max(lo, 0), min(lo + in_rows + 2, in_total))
        window[:, cols - lo] = whole[:, cols]
        if np.count_nonzero(whole) != np.count_nonzero(window):
            raise ValueError(f"a resize of {in_total} to {out_total} rows reaches past one "
                             f"halo row of a rank's {in_rows}")
        m = _MATRICES[key] = kept_constant(window, dtype, device)
    return m


def resize_rows(x: torch.Tensor, out_rows: int, dim: int, ex: Exchanger) -> torch.Tensor:
    """Resize ``x``'s rows on ``dim`` (this rank's block of the image's
    ``n * x.shape[dim]``) to this rank's ``out_rows`` of the image's ``n *
    out_rows``, align-corners bilinear: the rank's rows of the global
    matrix by the rank's rows with one halo row on each side. An output
    row's source coordinate ``o (H_in - 1) / (H_out - 1)`` lies within half
    a row of ``o H_in / H_out`` for the models' 2x resizes, so one halo row
    is enough (checked when the matrix is built)."""
    in_rows = x.shape[dim]
    if in_rows == out_rows:
        return x
    m = _row_matrix(in_rows * ex.size, out_rows * ex.size, ex.index, in_rows, out_rows,
                    x.dtype, x.device)
    xh = halo_rows(x, ex, dim)
    return torch.movedim(torch.movedim(xh, dim, -1) @ m.t(), -1, dim)
