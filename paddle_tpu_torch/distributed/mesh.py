"""The hybrid training mesh over ``torch.distributed`` ranks, its partition
specs, and the differentiable collectives of the mesh training path.

The reference lays its devices out as ``jax.sharding.Mesh(devices.reshape(
dp, pp, sharding, sep, mp), ("dp", "pp", "sharding", "sep", "mp"))``
(``paddle_tpu/models/llama.py:make_mesh``) and lets GSPMD place the
collectives.  Here one process is one mesh position: rank ``r`` sits at
the coordinates of ``jax.devices()[r]`` in that array (row-major over the
axes in that order), and the collectives are written out, each an
autograd ``Function`` whose backward is the transpose JAX uses:

========================  ==============================  =====================
collective                forward                         backward
========================  ==============================  =====================
:func:`psum`              sum all-reduce                  identity
:func:`copy_to`           identity                        sum all-reduce
:func:`all_gather`        all-gather along ``dim``        reduce-scatter
:func:`reduce_scatter`    reduce-scatter along ``dim``    all-gather
:func:`ppermute`          shift by ``shift`` positions    shift back
                          (``wrap=False``: open chain,    (the reversed chain)
                          the ends receive zeros)
:func:`all_to_all`        ``lax.all_to_all(tiled=True)``  the inverse all-to-all
========================  ==============================  =====================

``psum`` and ``copy_to`` are Megatron's *g* and *f*: every rank of an
axis computes the same (replicated) loss, so the cotangent of a
replicated value is already whole on each rank, and the cotangent of a
value each rank feeds from its own shard is summed.  (The autograd
all-reduce of ``torch.distributed.nn`` sums in its backward too, which
under that convention counts the loss once a rank.)

A spec is a tuple with one entry a dimension, as ``PartitionSpec``: None
(replicated), an axis name, or a tuple of axis names (split over their
product, the first the slowest).  :func:`shard_leaf` cuts a rank's
contiguous slice; :func:`unshard_leaf` gathers it back (for checks).

Transport: the process group's backend.  On one card that is gloo, for
CPU and CUDA tensors alike (one card cannot hold two NCCL ranks).
gloo's point-to-point ops take CPU tensors only, so under gloo
:func:`exchange` (and :func:`ppermute`, which runs through it) copies a
CUDA tensor to the host, exchanges it there and copies the result back:
explicit staging, counted in ``COUNTERS["host_staged"]``.  Every other
op passes CUDA tensors to gloo, which stages them itself.  A collective
the backend refuses raises; none falls back.

:func:`exchange` is the pipeline's point-to-point transport outside
autograd: the tensors a rank sends to and receives from other positions
of one line in a tick (the 1F1B activations and cotangents, the VPP
layer reorder).

:data:`COUNTERS` counts each collective a transport call made (forward
and backward, recompute included) and the bytes it carried; with
:data:`TIMING` on, ``COUNTERS["seconds"]`` adds the wall time of each,
measured between two device synchronizations (so the time waiting for
earlier kernels is left out).
"""

from __future__ import annotations

import itertools
import math
import time

import torch
import torch.distributed as dist

#: the axis names in the reference's ``make_mesh`` order
AXES = ("dp", "pp", "sharding", "sep", "mp")

#: transport calls by kind (``send_recv``: each tensor :func:`exchange`
#: sent or received), the bytes they carried (a rank's input; what
#: ``exchange`` sent), and host-staged exchange calls; a caller resets
#: them with :func:`reset_counters`
COUNTERS = {"all_reduce": 0, "all_reduce_max": 0, "all_gather": 0,
            "reduce_scatter": 0, "all_to_all": 0, "ppermute": 0,
            "send_recv": 0, "host_staged": 0, "bytes": 0, "seconds": 0.0}
#: time each collective (``COUNTERS["seconds"]``), synchronizing the card
#: before and after it
TIMING = {"on": False}


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0.0 if k == "seconds" else 0


class Mesh:
    """The ranks of the default process group laid out over :data:`AXES`.

    ``shape`` maps each axis to its size (1 where absent); ``coords`` this
    rank's coordinate on each.  Every rank creates, in one fixed order,
    one group for each line of every nonempty set of axes of size > 1
    (``dist.new_group`` must be called by every rank for every group) and
    keeps those holding it: :meth:`group` looks one up.  A one-position
    mesh needs no process group and holds none."""

    def __init__(self, dp=1, pp=1, sharding=1, sep=1, mp=1):
        self.shape = {"dp": dp, "pp": pp, "sharding": sharding, "sep": sep,
                      "mp": mp}
        for a, n in self.shape.items():
            if int(n) != n or n < 1:
                raise ValueError(f"mesh axis {a!r} has size {n}")
        self.size = math.prod(self.shape.values())
        inited = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if inited else 1
        if world != self.size:
            raise ValueError(
                f"a mesh of {self.size} positions {self.shape} needs a "
                f"process group of that size, got a world of {world}"
                + ("" if inited else " (no process group initialised)"))
        self.rank = dist.get_rank() if inited else 0
        self.coords = self.coords_of(self.rank)
        self._groups = {}
        live = [a for a in AXES if self.shape[a] > 1]
        for k in range(1, len(live) + 1):
            for axes in itertools.combinations(live, k):
                for ranks in self._lines(axes):
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def _lines(self, axes):
        """Each line of ``axes``: the ranks that differ only there, in
        rank order (their combined coordinate over ``axes``)."""
        others = [a for a in AXES if a not in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            pos = dict(zip(others, fixed))
            ranks = []
            for free in itertools.product(*(range(self.shape[a])
                                            for a in axes)):
                pos.update(zip(axes, free))
                ranks.append(self.rank_of(pos))
            out.append(sorted(ranks))
        return out

    def coords_of(self, rank: int) -> dict:
        """Rank ``rank``'s coordinate on each axis (row-major over
        :data:`AXES`)."""
        coords = {}
        for a in reversed(AXES):
            rank, coords[a] = divmod(rank, self.shape[a])
        return {a: coords[a] for a in AXES}

    def rank_of(self, coords: dict) -> int:
        r = 0
        for a in AXES:
            r = r * self.shape[a] + coords.get(a, 0)
        return r

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _names(axes))

    def axis_index(self, axes) -> int:
        """This rank's combined coordinate over ``axes`` (the first the
        slowest), as ``lax.axis_index`` over a tuple of axes."""
        i = 0
        for a in _names(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The group of this rank's line over ``axes`` (None when it holds
        one rank).  Its group ranks follow the combined coordinate only
        when ``axes`` are in :data:`AXES` order, which the collectives
        require."""
        names = tuple(a for a in AXES if a in _names(axes)
                      and self.shape[a] > 1)
        if [a for a in _names(axes) if self.shape[a] > 1] != list(names):
            raise ValueError(f"axes {axes} out of the mesh's order {AXES}")
        return self._groups.get(names) if names else None


def _names(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def spec_axes(spec) -> tuple:
    """Every axis name a spec splits over, in order."""
    return tuple(a for entry in spec for a in _names(entry))


def shard_leaf(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice of the whole leaf ``t`` under
    ``spec`` (entries past the spec's length are replicated); a dim its
    axes do not divide raises ``ValueError``."""
    for d, entry in enumerate(spec):
        n = mesh.axis_size(entry)
        if n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of a {tuple(t.shape)} leaf does not "
                             f"split over {entry} ({n})")
        w = t.shape[d] // n
        t = t.narrow(d, mesh.axis_index(entry) * w, w)
    return t.contiguous()


def unshard_leaf(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's :func:`shard_leaf` slice (a
    collective over the spec's axes; for tests and checks)."""
    with torch.no_grad():
        for d, entry in enumerate(spec):
            if mesh.axis_size(entry) > 1:
                t = _gather(t, mesh, entry, d)
    return t


# ---------------------------------------------------------------------------
# transport (no autograd)
# ---------------------------------------------------------------------------

class _Timed:
    def __init__(self, kind, t, sent=True):
        self.kind, self.t, self.sent = kind, t, sent

    def __enter__(self):
        COUNTERS[self.kind] += 1
        if self.sent:
            COUNTERS["bytes"] += self.t.numel() * self.t.element_size()
        if TIMING["on"]:
            _sync(self.t)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if TIMING["on"]:
            _sync(self.t)
            COUNTERS["seconds"] += time.perf_counter() - self.t0


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _all_reduce(x, mesh, axes, op="sum"):
    g = mesh.group(axes)
    y = x.contiguous().clone()
    if g is None:
        return y
    with _Timed("all_reduce" if op == "sum" else "all_reduce_max", y):
        dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=g)
    return y


def _gather(x, mesh, axes, dim):
    g, n = mesh.group(axes), mesh.axis_size(axes)
    if g is None:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
    with _Timed("all_gather", xs):
        dist.all_gather_into_tensor(out, xs, group=g)
    return out.movedim(0, dim)


def _scatter(x, mesh, axes, dim):
    g, n = mesh.group(axes), mesh.axis_size(axes)
    if g is None:
        return x
    xs = x.movedim(dim, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    with _Timed("reduce_scatter", xs):
        dist.reduce_scatter_tensor(out, xs, group=g)
    return out.movedim(0, dim)


def _shift(x, mesh, axes, shift, wrap=True):
    """Position ``i`` of the line receives what position ``i - shift``
    sent; ``wrap=False`` is the open chain: positions with no source
    receive zeros and those with no destination send nothing.  One
    :func:`exchange`, counted as one ``ppermute``."""
    g, n = mesh.group(axes), mesh.axis_size(axes)
    if g is None or shift % n == 0:
        return x
    idx = mesh.axis_index(axes)
    dst, src_pos = idx + shift, idx - shift
    sends = [(dst % n, x, 0)] if wrap or 0 <= dst < n else []
    recvs = [(src_pos % n, x, 0)] if wrap or 0 <= src_pos < n else []
    got = exchange(mesh, axes, sends, recvs, kind="ppermute")
    return got[0] if got else torch.zeros_like(x)


def exchange(mesh, axes, sends=(), recvs=(), kind=None) -> list:
    """Point-to-point over ``mesh``'s line of ``axes``, outside autograd:
    ``sends`` is ``(position, tensor, tag)`` triples, ``recvs`` is
    ``(position, like, tag)`` triples (``like`` a tensor whose shape,
    dtype and device the received one takes); returns the received
    tensors in ``recvs``' order.  The peers must post the matching
    ``(tag)`` ops in the same call of theirs.  Each tensor sent or
    received counts one ``send_recv`` (or the call counts one ``kind``),
    the sent bytes count, and gloo's point-to-point ops take CPU tensors
    only: under gloo a call with a CUDA tensor is staged through the host
    (one ``host_staged``).  A call with nothing to move returns at once."""
    if not sends and not recvs:
        return []
    g = mesh.group(axes)
    if g is None:
        raise ValueError(f"exchange over {axes}: the line holds one rank")
    ranks = dist.get_process_group_ranks(g)
    tensors = [t for _, t, _ in list(sends) + list(recvs)]
    staged = (any(t.is_cuda for t in tensors)
              and dist.get_backend(g) == "gloo")
    if staged:
        COUNTERS["host_staged"] += 1
    host = (lambda t: t.cpu()) if staged else (lambda t: t)
    out_bufs = [torch.empty(like.shape, dtype=like.dtype,
                            device="cpu" if staged else like.device)
                for _, like, _ in recvs]
    ops = [dist.P2POp(dist.isend, host(t.contiguous()), ranks[pos],
                      group=g, tag=tag) for pos, t, tag in sends]
    ops += [dist.P2POp(dist.irecv, buf, ranks[pos], group=g, tag=tag)
            for (pos, _, tag), buf in zip(recvs, out_bufs)]
    if kind is None:
        COUNTERS["send_recv"] += len(ops)
    else:
        COUNTERS[kind] += 1
    COUNTERS["bytes"] += sum(t.numel() * t.element_size()
                             for _, t, _ in sends)
    t0 = None
    if TIMING["on"]:
        _sync(tensors[0])
        t0 = time.perf_counter()
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if t0 is not None:
        _sync(tensors[0])
        COUNTERS["seconds"] += time.perf_counter() - t0
    return [buf.to(like.device) if staged else buf
            for (_, like, _), buf in zip(recvs, out_bufs)]


def _a2a(x, mesh, axes, split_axis, concat_axis):
    """``lax.all_to_all(x, axes, split_axis, concat_axis, tiled=True)``:
    ``x`` cut in n along ``split_axis``, piece j to position j, the pieces
    received concatenated along ``concat_axis`` in source order."""
    g, n = mesh.group(axes), mesh.axis_size(axes)
    if g is None:
        return x
    shape = list(x.shape)
    if shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(shape)} "
                         f"does not split {n} ways")
    piece = shape[:split_axis] + [n, shape[split_axis] // n] \
        + shape[split_axis + 1:]
    xs = x.reshape(piece).movedim(split_axis, 0).contiguous()
    out = torch.empty_like(xs)
    with _Timed("all_to_all", xs):
        dist.all_to_all_single(out, xs, group=g)
    # out[j] is position j's piece: put the source dim before concat_axis
    # and merge it into that dim
    y = out.movedim(0, concat_axis)
    merged = list(y.shape)
    merged[concat_axis:concat_axis + 2] = [merged[concat_axis]
                                           * merged[concat_axis + 1]]
    return y.reshape(merged)


# ---------------------------------------------------------------------------
# the differentiable collectives
# ---------------------------------------------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.meta = (mesh, axes, dim)
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.meta), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.meta = (mesh, axes, dim)
        return _scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.meta), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, shift, wrap):
        ctx.meta = (mesh, axes, shift, wrap)
        return _shift(x, mesh, axes, shift, wrap)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, shift, wrap = ctx.meta
        return _shift(g, mesh, axes, -shift, wrap), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_axis, concat_axis):
        ctx.meta = (mesh, axes, split_axis, concat_axis)
        return _a2a(x, mesh, axes, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_axis, concat_axis = ctx.meta
        return (_a2a(g, mesh, axes, concat_axis, split_axis), None, None,
                None, None)


def psum(x, mesh: Mesh, axes):
    """Sum over ``axes``; the cotangent passes through (Megatron's g)."""
    return x if mesh.group(axes) is None else _Psum.apply(x, mesh, axes)


def copy_to(x, mesh: Mesh, axes):
    """Identity; the cotangent is summed over ``axes`` (Megatron's f)."""
    return x if mesh.group(axes) is None else _CopyTo.apply(x, mesh, axes)


def all_gather(x, mesh: Mesh, axes, dim: int):
    """Concatenate every position's ``x`` along ``dim`` in axis order."""
    if mesh.group(axes) is None:
        return x
    return _AllGather.apply(x, mesh, axes, dim)


def reduce_scatter(x, mesh: Mesh, axes, dim: int):
    """Sum over ``axes``, each position keeping its slice of ``dim``."""
    if mesh.group(axes) is None:
        return x
    return _ReduceScatter.apply(x, mesh, axes, dim)


def ppermute(x, mesh: Mesh, axes, shift: int = 1, wrap: bool = True):
    """Position ``i`` gets position ``i - shift``'s ``x`` (mod the axis
    size): ``lax.ppermute`` with ``perm = [(i, i + shift)]``.
    ``wrap=False``: the open chain ``perm = [(i, i + shift)]`` over the
    positions inside the line; the others receive zeros."""
    if mesh.group(axes) is None:
        return x
    return _Ppermute.apply(x, mesh, axes, shift, wrap)


def all_to_all(x, mesh: Mesh, axes, split_axis: int, concat_axis: int):
    """``lax.all_to_all(x, axes, split_axis, concat_axis, tiled=True)``."""
    if mesh.group(axes) is None:
        return x
    return _AllToAll.apply(x, mesh, axes, split_axis, concat_axis)


def pmax(x, mesh: Mesh, axes):
    """Maximum over ``axes``, outside autograd (a softmax's shift)."""
    return _all_reduce(x.detach(), mesh, axes, op="max")


def all_reduce_(x, mesh: Mesh, axes):
    """In-place sum over ``axes`` outside autograd (gradient sync)."""
    g = mesh.group(axes)
    if g is not None:
        with _Timed("all_reduce", x):
            dist.all_reduce(x, group=g)
    return x
