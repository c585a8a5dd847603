"""The 'space' axis: activations sharded over the image's rows, with the
row exchanges that the models' operations need (the port's counterpart of
what GSPMD inserts for the JAX package's ``P('data', 'space')`` batches).

Each of the ``n`` ranks of a space group holds a block of consecutive rows
of every activation. At the image's level the blocks are equal (``H / n``
rows each, the JAX package's condition: ``n`` divides ``H``); each deeper
level's blocks follow from the level above by the max-pool's floor
(:class:`RowPlan`), so they may differ by a row, hold one row or none. An
:class:`Exchanger` moves rows between the ranks:

- :class:`GroupExchanger`: the space ranks of a ``torch.distributed``
  process group (training, the evaluators). Its exchange is one
  ``all_gather`` of each rank's edge rows over the group, which gloo and
  NCCL both run on CUDA and CPU tensors alike;
- :class:`ThreadExchanger`: threads of one process (serving), one per space
  device, meeting at a barrier to read each other's rows. A CUDA producer
  records an event on its stream, and the reader's stream waits for it.

Every row exchange is :func:`move_rows`: each rank gives its block and
takes a window of the level's global rows a few rows wider or narrower,
zeros past the image. Inside :func:`scope` of an exchanger and the image
height the models' operations run on the rank's rows and name the level
they work at: ``models/blocks.py::conv_bn`` pads its 3x3 conv with
:func:`halo` rows, the max-pool takes its pairs of rows through
:func:`pool_rows`, a level-up comes to the skip's rows, padded as ``Up``
pads the whole image, through :func:`pad_rows` (the transposed conv) or
:func:`upsample_rows` (the bilinear upsample), the attention gate's stride
2 takes the even rows through :func:`stride2_rows` and its resize runs
through :func:`resize_rows`, and the int8 executor (``ops/quantize.py``)
does the same on its NHWC tensors. A block with no rows still takes part
in every exchange: the plan, not the data, says which rows are real, and
every rank makes the same collectives in the same order.

Gradients follow the convention of ``losses/reduction.py``: the mean of
the ranks' gradients is the global gradient. A moved row's gradient goes
back to the rank the row came from; :func:`space_sum` (the Dice sums over
an image's rows) all-reduces in both directions; :func:`split_rows` gives a
replicated input's gradient the rank's rows only.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEPTH = 4  # the models' max-pool levels: the bottleneck is H // 16 rows

Block = Tuple[int, int]  # [start, stop) of a level's global rows

# Exchanges made and bytes this rank contributed to them, since the last reset.
COUNTERS = {"exchanges": 0, "bytes": 0}

_STATE = threading.local()


class RowPlan:
    """The global rows ``[start, stop)`` each of ``n`` space ranks holds at
    each of ``depth + 1`` levels of an image of ``height`` rows: equal
    blocks at level 0, and at each deeper level the pooled rows ``k`` whose
    pair ``2k, 2k + 1`` starts in the rank's block one level up and lies
    inside that level (the max-pool's floor drops an odd last row). E.g.
    ``height`` 40 on 2 ranks: 20/20, 10/10, 5/5, 3/2, 2/0 rows."""

    def __init__(self, height: int, n: int, depth: int = DEPTH):
        h = height // n
        level = tuple((r * h, (r + 1) * h) for r in range(n))
        self.levels: List[Tuple[Block, ...]] = [level]
        self.totals: List[int] = [height]
        for _ in range(depth):
            total = self.totals[-1] // 2
            level = tuple((min(-(-a // 2), total), min(-(-b // 2), total)) for a, b in level)
            self.levels.append(level)
            self.totals.append(total)


@functools.lru_cache(maxsize=None)
def row_plan(height: int, n: int, depth: int = DEPTH) -> RowPlan:
    """The kept :class:`RowPlan` of ``height`` rows over ``n`` ranks."""
    return RowPlan(height, n, depth)


def current() -> Optional["Exchanger"]:
    """The exchanger of this thread's :func:`scope` (None outside one)."""
    return getattr(_STATE, "exchanger", None)


def current_plan() -> Optional[RowPlan]:
    """The :class:`RowPlan` of this thread's :func:`scope` (None outside one)."""
    return getattr(_STATE, "plan", None)


@contextlib.contextmanager
def scope(exchanger: Optional["Exchanger"], height: Optional[int] = None, *,
          plan: Optional[RowPlan] = None):
    """Run the models' row operations on this rank's rows through
    ``exchanger`` (None: whole images) inside the ``with`` block, in this
    thread. ``height`` is the whole image's row count at level 0 (or
    ``plan`` the :class:`RowPlan` itself)."""
    if exchanger is not None and plan is None:
        if height is None:
            raise ValueError("a 'space' scope needs the image height")
        check_rows(height, exchanger.size)
        plan = row_plan(height, exchanger.size)
    before = current(), current_plan()
    _STATE.exchanger, _STATE.plan = exchanger, (plan if exchanger is not None else None)
    try:
        yield exchanger
    finally:
        _STATE.exchanger, _STATE.plan = before


def check_rows(height: int, n_space: int) -> None:
    """ValueError unless ``n_space`` divides the image ``height``: the JAX
    package's condition. Every deeper level splits as :class:`RowPlan`
    says, however uneven."""
    if n_space > 1 and height % n_space:
        raise ValueError(f"--n_space {n_space} must divide the image height {height}")


class Exchanger:
    """The rows of the other ranks of one space group: ``index`` of
    ``size``. Subclasses give :meth:`all_gather`; :class:`GroupExchanger`
    also the ``all_reduce`` that training's backward needs."""

    index: int
    size: int

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape on all), in rank order, on ``t``'s device."""
        raise NotImplementedError


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
# Moving rows between the ranks
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


class _Route:
    """The static routing of one :func:`move_rows` from every rank's block
    ``have`` to every rank's window ``want``. ``depth`` is the most rows a
    window reaches past its own block into another rank's (0: no exchange;
    rows that no block holds are zeros).
    Each rank sends its first and last ``depth`` rows (zeros where its
    block is shorter); ``take[i]`` lists rank ``i``'s window as runs
    ``(kind, j, at, rows)``: its own rows from ``at`` ('own'), a sender
    ``j``'s first ('top') or last ('bottom') rows from ``at``, or ``rows``
    zeros past the image ('zero'). ``give[i]`` lists, for the backward,
    where the gradient of the rows of rank ``i``'s block that other
    windows took comes from: ``(j, side, at, local_row)``, the row ``at``
    of the part that rank ``j`` sends back above (side 0) or below (side 1)
    its block."""

    def __init__(self, have: Tuple[Block, ...], want: Tuple[Block, ...]):
        if len(have) != len(want):
            raise ValueError(f"{len(have)} blocks moved to {len(want)} windows")
        for (a, b), (c, d) in zip(have, want):
            if b < a or d < c:
                raise ValueError(f"a block {(a, b)} or window {(c, d)} runs backwards")
        depth = 0
        for i, ((a, b), (c, d)) in enumerate(zip(have, want)):
            for r in range(c, d):
                j = _owner(have, r)
                if j is not None and j != i:
                    depth = max(depth, a - r if r < a else r - b + 1)
        self.depth = depth
        self.take = [self._take(i, have, want[i], depth) for i in range(len(have))]
        self.give = [[] for _ in have]
        for j, ((a, b), (c, d)) in enumerate(zip(have, want)):
            for side, rows in ((0, range(c, min(a, d))), (1, range(max(b, c), d))):
                for r in rows:
                    owner = _owner(have, r)
                    if owner is None or owner == j:
                        continue
                    at = r - (a - depth) if side == 0 else r - b
                    self.give[owner].append((j, side, at, r - have[owner][0]))

    @staticmethod
    def _take(i, have, window, depth):
        c, d = window
        runs: List[Tuple[str, int, int, int]] = []
        for r in range(c, d):
            j = _owner(have, r)
            if j is None:
                run = ("zero", -1, 0, 1)
            elif j == i:
                run = ("own", i, r - have[i][0], 1)
            else:
                a, b = have[j]
                if r - a < depth:
                    run = ("top", j, r - a, 1)
                elif b - r <= depth:
                    run = ("bottom", j, depth - (b - r), 1)
                else:
                    raise ValueError(f"row {r} of rank {j}'s block {(a, b)} lies more than "
                                     f"{depth} rows from its edges")
            last = runs[-1] if runs else None
            if last and last[0] == run[0] and last[1] == run[1] and \
                    (run[0] == "zero" or last[2] + last[3] == run[2]):
                runs[-1] = (last[0], last[1], last[2], last[3] + 1)
            else:
                runs.append(run)
        return runs


def _owner(have: Tuple[Block, ...], r: int) -> Optional[int]:
    for j, (a, b) in enumerate(have):
        if a <= r < b:
            return j
    return None


@functools.lru_cache(maxsize=None)
def _route(have: Tuple[Block, ...], want: Tuple[Block, ...]) -> _Route:
    return _Route(have, want)


def _edge_rows(x: torch.Tensor, dim: int, depth: int) -> torch.Tensor:
    """(2, ...): ``x``'s first ``depth`` rows on ``dim`` (zeros after a
    short block's end) and its last ``depth`` (zeros before its start)."""
    h = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = depth
    out = x.new_zeros((2, *shape))
    k = min(h, depth)
    if k:
        out[0].narrow(dim, 0, k).copy_(x.narrow(dim, 0, k))
        out[1].narrow(dim, depth - k, k).copy_(x.narrow(dim, h - k, k))
    return out


def _exchange(ex: Exchanger, edges: torch.Tensor) -> List[torch.Tensor]:
    COUNTERS["exchanges"] += 1
    COUNTERS["bytes"] += edges.numel() * edges.element_size()
    return ex.all_gather(edges.contiguous())


def _take_rows(x, ex, dim, route: _Route):
    parts = _exchange(ex, _edge_rows(x, dim, route.depth)) if route.depth else None
    pieces = []
    for kind, j, at, rows in route.take[ex.index]:
        if kind == "own":
            pieces.append(x.narrow(dim, at, rows))
        elif kind == "zero":
            shape = list(x.shape)
            shape[dim] = rows
            pieces.append(x.new_zeros(shape))
        else:
            pieces.append(parts[j][0 if kind == "top" else 1].narrow(dim, at, rows))
    if not pieces:
        pieces = [x.narrow(dim, 0, 0)]
    return _cat_rows(pieces, dim, _format(x))


def _give_rows(g, ex, dim, route: _Route, have: Block, want: Block, fmt):
    """The backward of :func:`_take_rows`: this rank's block's gradient, its
    own rows' from ``g`` plus the gradients of the rows that the other
    windows took (their senders place each at its distance from their
    block: the rows above the block to end at its start, those below to
    start at its end)."""
    depth = route.depth
    (a, b), (c, d) = have, want
    shape = list(g.shape)
    shape[dim] = b - a
    dx = torch.zeros(shape, dtype=g.dtype, device=g.device).contiguous(memory_format=fmt)
    lo, hi = max(a, c), min(b, d)
    if hi > lo:
        dx.narrow(dim, lo - a, hi - lo).add_(g.narrow(dim, lo - c, hi - lo))
    if not depth:
        return dx
    shape[dim] = depth
    back = g.new_zeros((2, *shape))
    # (Rows further out are zeros past the image: their gradients go nowhere.)
    lo, hi = max(c, a - depth), min(a, d)
    if hi > lo:
        back[0].narrow(dim, lo - (a - depth), hi - lo).copy_(g.narrow(dim, lo - c, hi - lo))
    lo, hi = max(b, c), min(d, b + depth)
    if hi > lo:
        back[1].narrow(dim, lo - b, hi - lo).copy_(g.narrow(dim, lo - c, hi - lo))
    parts = _exchange(ex, back)
    for j, side, pos, row in route.give[ex.index]:
        dx.narrow(dim, row, 1).add_(parts[j][side].narrow(dim, pos, 1))
    return dx


class _Move(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex, dim, have, want):
        ctx.ex, ctx.dim, ctx.have, ctx.want = ex, dim, have, want
        ctx.fmt = _format(x)
        return _take_rows(x, ex, dim, _route(have, want))

    @staticmethod
    def backward(ctx, g):
        i = ctx.ex.index
        return (_give_rows(g, ctx.ex, ctx.dim, _route(ctx.have, ctx.want), ctx.have[i],
                           ctx.want[i], ctx.fmt), None, None, None, None)


def move_rows(x: torch.Tensor, have: Sequence[Block], want: Sequence[Block], ex: Exchanger,
              dim: int = 2) -> torch.Tensor:
    """Turn this rank's rows ``have[ex.index]`` of a level's image (axis
    ``dim`` of ``x``) into its window ``want[ex.index]`` of them: global
    ``[start, stop)`` rows, every rank's given, so each rank knows where
    each row lies. The blocks of ``have`` are the level's rows in rank
    order; a window may reach a few rows past its block (the same number
    on every rank is exchanged: one ``all_gather`` of each rank's first and
    last rows, none when no window reaches past its block) and rows that no
    block holds (past the image) are zeros. A new tensor in ``x``'s memory
    format, or ``x`` itself when every window is its block. The backward
    adds each row's gradients, from every window that took it, on the rank
    that holds the row."""
    have = tuple((int(a), int(b)) for a, b in have)
    want = tuple((int(c), int(d)) for c, d in want)
    a, b = have[ex.index]
    if x.shape[dim] != b - a:
        raise ValueError(f"rank {ex.index} holds {x.shape[dim]} rows, its block {(a, b)} "
                         f"{b - a}")
    if have == want:
        return x
    return _Move.apply(x, ex, dim, have, want)


def _equal_blocks(rows: int, n: int) -> Tuple[Block, ...]:
    return tuple((r * rows, (r + 1) * rows) for r in range(n))


def halo_rows(x: torch.Tensor, ex: Exchanger, dim: int = 2,
              blocks: Optional[Sequence[Block]] = None) -> torch.Tensor:
    """``x`` (this rank's rows on ``dim``) with one row above and one below
    from the ranks that hold them (``blocks``: every rank's rows, equal
    blocks of ``x``'s size by default), zeros at the image's first and last
    rows: what a 3x3 conv's padding needs. A new tensor in ``x``'s memory
    format. The backward adds the halo rows' gradients to the rows they
    came from."""
    if blocks is None:
        blocks = _equal_blocks(x.shape[dim], ex.size)
    return move_rows(x, blocks, tuple((a - 1, b + 1) for a, b in blocks), ex, dim)


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
    """This rank's block of ``x``'s rows on ``dim`` (a new tensor; level 0's
    blocks are equal); ``x`` without an exchanger. The backward gives the
    replicated input the gradient of the rank's rows only: the mean over
    the ranks is the whole gradient."""
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
    """The whole image's rows on ``dim`` from every rank's block of level
    0, on every rank (:func:`split_rows`' inverse); ``x`` without an
    exchanger."""
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
# The models' row operations at a level of the scope's plan
# ---------------------------------------------------------------------------

def _scoped(level: int) -> Optional[Tuple[Exchanger, RowPlan]]:
    ex = current()
    if ex is None:
        return None
    plan = current_plan()
    if not 0 <= level < len(plan.levels):
        raise ValueError(f"level {level} is not one of the plan's {len(plan.levels)}")
    return ex, plan


def empty_safe(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, min_rows: int,
               dim: int = 2) -> torch.Tensor:
    """``fn(x)`` where ``x`` may be too short for ``fn``: a block with no
    rows (the halo'd two rows of one, for a 3x3 conv), which PyTorch's
    convs and pools refuse and which gives no output rows. Such an ``x``
    goes through ``fn`` with zero rows added up to ``min_rows`` and
    ``fn``'s output is cut to none, so that the backward still runs through
    ``fn`` and reaches the exchanges before it, as on the other ranks."""
    if x.shape[dim] >= min_rows:
        return fn(x)
    shape = list(x.shape)
    shape[dim] = min_rows - x.shape[dim]
    return fn(torch.cat([x, x.new_zeros(shape)], dim)).narrow(dim, 0, 0)


def halo(x: torch.Tensor, level: int, dim: int = 2) -> torch.Tensor:
    """:func:`halo_rows` of this rank's rows of ``level`` under the scope."""
    ex, plan = _scoped(level)
    return halo_rows(x, ex, dim, plan.levels[level])


def pool_rows(x: torch.Tensor, level: int, dim: int = 2) -> torch.Tensor:
    """This rank's rows of ``level - 1`` turned into the pairs of rows that
    a 2x2 max-pool turns into its rows of ``level``: global rows ``[2s,
    2e)`` for its block ``[s, e)``. ``x`` itself outside a scope."""
    scoped = _scoped(level)
    if scoped is None:
        return x
    ex, plan = scoped
    return move_rows(x, plan.levels[level - 1], tuple((2 * a, 2 * b) for a, b in
                                                    plan.levels[level]), ex, dim)


def stride2_rows(x: torch.Tensor, level: int, dim: int = 2) -> torch.Tensor:
    """This rank's rows of ``level`` turned into the rows whose even ones a
    stride-2 1x1 conv samples for the rank: global rows ``[2 ceil(s / 2), 2
    ceil(e / 2))`` for its block ``[s, e)``. A zero row follows an odd
    image's last row; the ``ceil(H / 2)`` outputs split as the stride's
    sampling does, so their last one lies on the rank that holds the
    image's last row. ``x`` itself outside a scope."""
    scoped = _scoped(level)
    if scoped is None:
        return x
    ex, plan = scoped
    blocks = plan.levels[level]
    return move_rows(x, blocks, tuple((2 * -(-a // 2), 2 * -(-b // 2)) for a, b in blocks),
                     ex, dim)


def pad_rows(x: torch.Tensor, level: int, dim: int = 2) -> torch.Tensor:
    """This rank's rows of a level-up of ``level + 1`` (the transposed
    conv's: global rows ``[2s, 2e)`` of ``2 H_{level+1}``) turned into its
    rows of ``level``, the image zero-padded to ``level``'s height as
    ``Up`` pads it: ``dh // 2`` rows above and the rest below (the row
    lands on the rank that holds the level's last row). ``x`` itself
    outside a scope."""
    scoped = _scoped(level)
    if scoped is None:
        return x
    ex, plan = scoped
    top = (plan.totals[level] - 2 * plan.totals[level + 1]) // 2
    return move_rows(x, tuple((2 * a, 2 * b) for a, b in plan.levels[level + 1]),
                     tuple((a - top, b - top) for a, b in plan.levels[level]), ex, dim)


_MATRICES: Dict[Tuple, torch.Tensor] = {}


def _resize_window(whole: np.ndarray, out: Block, start: int) -> Block:
    """The input rows ``[lo, hi)`` that output rows ``out`` (of ``whole``,
    rows past it are zeros) read; an empty window at ``start`` if none."""
    rows = whole[max(out[0], 0):min(out[1], whole.shape[0])]
    cols = np.flatnonzero(np.any(rows != 0, axis=0))
    return (int(cols[0]), int(cols[-1]) + 1) if cols.size else (start, start)


def _resize(x: torch.Tensor, level: int, out_total: int, dim: int) -> torch.Tensor:
    """This rank's rows of ``level + 1`` resized (align corners) from the
    image's ``H_{level+1}`` rows to ``out_total``, zero-padded to
    ``level``'s height as :func:`pad_rows` pads: its rows of ``level``. One
    :func:`move_rows` brings the input rows the rank's output rows read
    (one or two past its block), then the rank's rows of the global matrix
    multiply them: float64 -> float32 -> ``x.dtype``, as
    ``ops/resize.py::interp_matrix``."""
    from tpu_unet_torch.ops.resize import _interp_matrix, kept_constant

    ex, plan = _scoped(level)
    in_blocks, in_total = plan.levels[level + 1], plan.totals[level + 1]
    top = (plan.totals[level] - out_total) // 2
    outs = tuple((c - top, d - top) for c, d in plan.levels[level])
    key = (in_total, out_total, plan.levels[level + 1], outs)
    whole = _interp_matrix(in_total, out_total)
    windows = tuple(_resize_window(whole, o, a) for o, (a, _) in zip(outs, in_blocks))
    (lo, hi), (c, d) = windows[ex.index], outs[ex.index]
    mkey = key + (ex.index, x.dtype, torch.device(x.device))
    m = _MATRICES.get(mkey)
    if m is None:
        part = np.zeros((d - c, hi - lo), np.float64)
        for o in range(max(c, 0), min(d, out_total)):
            part[o - c] = whole[o, lo:hi]
        m = _MATRICES[mkey] = kept_constant(part, x.dtype, x.device)
    xw = move_rows(x, in_blocks, windows, ex, dim)
    return torch.movedim(torch.movedim(xw, dim, -1) @ m.t(), -1, dim)


def resize_rows(x: torch.Tensor, level: int, dim: int) -> torch.Tensor:
    """This rank's rows of ``level + 1`` resized align-corners to its rows
    of ``level`` (the whole image's ``H_{level+1}`` rows to ``H_level``:
    the attention gate's resize of psi)."""
    return _resize(x, level, current_plan().totals[level], dim)


def upsample_rows(x: torch.Tensor, level: int, dim: int) -> torch.Tensor:
    """This rank's rows of ``level + 1`` upsampled 2x (align corners) and
    zero-padded to ``level``'s height (the bilinear ``Up``'s upsample and
    pad): its rows of ``level``."""
    return _resize(x, level, 2 * current_plan().totals[level + 1], dim)
