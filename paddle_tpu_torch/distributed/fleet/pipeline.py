"""Pipeline parallelism over the ``pp`` axis of a training mesh
(counterpart of ``paddle_tpu/distributed/fleet/pipeline.py``).

Each pipeline stage is a ``torch.distributed`` rank of a
:class:`~paddle_tpu_torch.distributed.mesh.Mesh` holding its stage's
contiguous slice of the stacked layer weights (``param_specs(pp=True)``
puts the layer dim over ``pp``).  A rank runs its stage's ticks eagerly:
stage compute on the valid ticks, and explicit activation and cotangent
exchanges with its neighbours on the ``pp`` line.  The reference runs the
same tick clocks as one SPMD program, ``lax.ppermute`` moving the values;
here the values move where the clock says one stage hands another one.

- :func:`gpipe_stacked` (FThenB): M + P - 1 ticks; at tick t stage s runs
  microbatch t - s and shifts its output to s + 1 (the open-chain
  :func:`~paddle_tpu_torch.distributed.mesh.ppermute`); the last stage's
  outputs are then summed over ``pp`` (``psum``), so every stage holds
  them whole.  The backward is autograd's, through the ``ppermute`` and
  ``psum`` transposes.  Autograd sees one rank's graph only, so each
  stage's ticks form one chain (:func:`after` ties a tick to the value it
  received even where the tick ignores it): every stage then runs every
  shift's transpose, in reverse tick order.
- :func:`one_f_one_b_stacked` (1F1B, VPP, ZB-H1): the reference's global
  clock, an F and a B sub-tick a tick (and ZB's W), ``f = k - s`` and
  ``b = k - D + s`` with ``D = 2(P - 1) + (C - 1)P``.  The F sub-tick
  runs the stage without autograd and keeps its input; the B sub-tick
  recomputes the stage forward from that input and runs
  ``torch.autograd.grad`` with the cotangent the next stage sent.
  Stage 0 owns the embedding, the last stage the loss head, one
  microbatch at a time.  The tensors move through
  :func:`~paddle_tpu_torch.distributed.mesh.exchange`, one call a tick:
  with one chunk an open chain, with C > 1 a ring (the wraparound edges
  carry the chunk handoffs).

The executed order of each run is kept in :data:`TRACE`.  The schedule
oracles (:func:`schedule_fthenb` ... :func:`format_schedule`) are the
reference's, kept here as plain Python; the executed clocks read against
them as follows: 1F1B and VPP run :func:`schedule_interleave`'s order at
their chunk count (one F and one B slot a tick, the F first, so at C = 1
a stage runs ``2(P - s) - 1`` forwards before its first backward, as
:func:`schedule_eager_1f1b`, not 1F1B's ``P - s - 1``); ZB-H1 runs that
order at C = 1 with a W tick after the backward of each of its first
``Z(s)`` microbatches; GPipe runs :func:`schedule_fthenb`'s forwards,
then its backwards in reverse microbatch order (autograd unwinds the tick
loop).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.autograd import grad

from .. import mesh as dmesh

#: the sub-ticks the last engine call ran on this rank, in order
TRACE: list = []


# ---------------------------------------------------------------------------
# the schedule oracles (the reference's, plain Python)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Tick:
    stage: int
    mb: int
    phase: str  # 'F' | 'B' | 'W' (W = weight-grad, zero-bubble split)
    chunk: int = 0


def schedule_fthenb(num_stages: int, num_micro: int) -> list[list[Tick]]:
    """All forwards then all backwards (the FThenB pass)."""
    per_stage = []
    for s in range(num_stages):
        ticks = [Tick(s, m, "F") for m in range(num_micro)]
        ticks += [Tick(s, m, "B") for m in range(num_micro)]
        per_stage.append(ticks)
    return per_stage


def schedule_1f1b(num_stages: int, num_micro: int) -> list[list[Tick]]:
    """1F1B: warmup = stages - 1 - s forwards, then steady alternation,
    then cooldown backwards."""
    per_stage = []
    for s in range(num_stages):
        warmup = min(num_stages - s - 1, num_micro)
        ticks = [Tick(s, m, "F") for m in range(warmup)]
        f = warmup
        b = 0
        while f < num_micro:
            ticks.append(Tick(s, f, "F"))
            f += 1
            ticks.append(Tick(s, b, "B"))
            b += 1
        while b < num_micro:
            ticks.append(Tick(s, b, "B"))
            b += 1
        per_stage.append(ticks)
    return per_stage


def schedule_interleave(num_stages: int, num_micro: int,
                        num_chunks: int = 2) -> list[list[Tick]]:
    """Interleaved / virtual-pipeline 1F1B: each stage owns num_chunks
    model chunks; microbatches round-robin chunks in groups of
    num_stages."""
    if num_micro % num_stages:
        raise AssertionError(
            "interleave requires num_micro % num_stages == 0")
    per_stage = []
    total = num_micro * num_chunks
    for s in range(num_stages):
        order_f = []
        for group_start in range(0, num_micro, num_stages):
            for chunk in range(num_chunks):
                for m in range(group_start,
                               min(group_start + num_stages, num_micro)):
                    order_f.append((m, chunk))
        warmup = min((num_stages - s - 1) * 2
                     + (num_chunks - 1) * num_stages, total)
        ticks = [Tick(s, m, "F", c) for m, c in order_f[:warmup]]
        fi = warmup
        bi = 0
        order_b = [(m, num_chunks - 1 - c) for m, c in order_f]
        while fi < total:
            m, c = order_f[fi]
            ticks.append(Tick(s, m, "F", c))
            fi += 1
            mb_, cb_ = order_b[bi]
            ticks.append(Tick(s, mb_, "B", cb_))
            bi += 1
        while bi < total:
            mb_, cb_ = order_b[bi]
            ticks.append(Tick(s, mb_, "B", cb_))
            bi += 1
        per_stage.append(ticks)
    return per_stage


def schedule_eager_1f1b(num_stages: int, num_micro: int) -> list[list[Tick]]:
    """Eager-1F1B: warmup deepens to 2*(P - s) - 1 forwards per stage, so
    more microbatches are in flight when the steady phase starts.
    Requires num_micro >= 2*P - 1."""
    if num_micro < 2 * num_stages - 1:
        raise AssertionError(
            f"eager-1F1B needs num_micro ({num_micro}) >= 2*stages - 1 "
            f"({2 * num_stages - 1}) — the reference pass asserts the same "
            "(pipeline_eager_1f1b.py:42); fewer microbatches would silently "
            "degrade to FThenB")
    per_stage = []
    for s in range(num_stages):
        warmup = min(2 * (num_stages - s) - 1, num_micro)
        ticks = [Tick(s, m, "F") for m in range(warmup)]
        f = warmup
        b = 0
        while f < num_micro:
            ticks.append(Tick(s, b, "B"))
            b += 1
            ticks.append(Tick(s, f, "F"))
            f += 1
        while b < num_micro:
            ticks.append(Tick(s, b, "B"))
            b += 1
        per_stage.append(ticks)
    return per_stage


def schedule_zero_bubble(num_stages: int,
                         num_micro: int) -> list[list[Tick]]:
    """ZB-H1: backward split into activation-grad (B) and weight-grad (W);
    W ticks fill the cooldown bubble."""
    per_stage = []
    for s in range(num_stages):
        warmup = min(num_stages - s - 1, num_micro)
        ticks = [Tick(s, m, "F") for m in range(warmup)]
        f, b, w = warmup, 0, 0
        while f < num_micro:
            ticks.append(Tick(s, f, "F"))
            f += 1
            ticks.append(Tick(s, b, "B"))
            b += 1
            if b - w > num_stages - s - 1:
                ticks.append(Tick(s, w, "W"))
                w += 1
        while b < num_micro:
            ticks.append(Tick(s, b, "B"))
            b += 1
            if b - w > num_stages - s - 1:
                ticks.append(Tick(s, w, "W"))
                w += 1
        while w < num_micro:
            ticks.append(Tick(s, w, "W"))
            w += 1
        per_stage.append(ticks)
    return per_stage


def format_schedule(per_stage: list[list[Tick]]) -> str:
    """One line a stage: ``stage{s}: F0 B0 ...`` (``.c`` after a nonzero
    chunk)."""
    lines = []
    for s, ticks in enumerate(per_stage):
        parts = [f"{t.phase}{t.mb}" + (f".{t.chunk}" if t.chunk else "")
                 for t in ticks]
        lines.append(f"stage{s}: " + " ".join(parts))
    return "\n".join(lines)


SCHEDULES = {
    "FThenB": schedule_fthenb,
    "1F1B": schedule_1f1b,
    "Eager1F1B": schedule_eager_1f1b,
    "Eager-1F1B": schedule_eager_1f1b,
    "Interleave": schedule_interleave,
    "VPP": schedule_interleave,
    "ZBH1": schedule_zero_bubble,
    "ZeroBubble": schedule_zero_bubble,
}


# ---------------------------------------------------------------------------
# GPipe (FThenB) through autograd
# ---------------------------------------------------------------------------

class _After(torch.autograd.Function):
    """``x``, made to depend on ``dep``: the cotangent passes to ``x`` and
    ``dep`` gets zeros, so autograd runs ``dep``'s producers on every
    rank whether or not this rank's value read it."""

    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return (g if ctx.needs_input_grad[0] else None,
                torch.zeros(shape, dtype=dtype, device=device))


def after(x, dep):
    """``x`` with an autograd edge to ``dep`` (zero cotangent)."""
    return _After.apply(x, dep)


def gpipe_stacked(stage_fn, microbatches, mesh, axis: str = "pp"):
    """GPipe over ``mesh``'s ``axis``: ``microbatches`` ``[M, mb, ...]``
    are stage 0's inputs (every stage passes them, so the chain below has
    a root on each); ``stage_fn(x) -> y`` applies this rank's stage.  M + P
    - 1 ticks: at tick t stage s runs microbatch t - s (when valid) and
    shifts its output to s + 1 on the open chain; stage 0 reads the
    microbatch, the others what they received.  Returns the last stage's
    ``[M, mb, ...]`` outputs on every stage (``psum`` over ``axis``: the
    other stages add zeros).  Differentiable: the backward runs every
    tick's shift transpose on every stage in reverse tick order."""
    P, s = mesh.axis_size(axis), mesh.axis_index(axis)
    M = microbatches.shape[0]
    TRACE.clear()
    zeros = torch.zeros(microbatches.shape[1:], dtype=microbatches.dtype,
                        device=microbatches.device)
    recv = after(zeros, microbatches)       # the chain's root
    outs, y = [], None
    for t in range(M + P - 1):
        i = t - s
        if 0 <= i < M:
            x_in = after(microbatches[i], recv) if s == 0 else recv
            y = stage_fn(x_in)
            TRACE.append(Tick(s, i, "F"))
            if y.requires_grad:
                y.register_hook(lambda g, i=i: TRACE.append(Tick(s, i, "B")))
            if s == P - 1:
                outs.append(y)
        else:
            y = after(zeros, recv)
        if t < M + P - 2:                   # the last tick's shift feeds none
            recv = dmesh.ppermute(y, mesh, axis, 1, wrap=False)
    if s == P - 1:
        buf = torch.stack(outs)
    else:
        buf = after(torch.zeros_like(microbatches), y)
    return dmesh.psum(buf, mesh, axis)


# ---------------------------------------------------------------------------
# the executed 1F1B clock (1F1B, VPP, ZB-H1)
# ---------------------------------------------------------------------------

class Clock:
    """The reference's global clock for P stages, M microbatches and C
    chunks: tick ``k`` runs at stage ``s`` the F of ``order_f[k - s]``
    and the B of ``order_b[k - D + s]`` (``order_b`` is ``order_f`` with
    the chunks mirrored), and under ZB-H1 the W of microbatch ``k - s -
    M`` for the first ``Z(s)`` microbatches."""

    def __init__(self, P: int, M: int, C: int = 1, zero_bubble=False):
        self.P, self.M, self.C, self.zb = P, M, C, zero_bubble
        self.total = M * C
        self.D = 2 * (P - 1) + (C - 1) * P
        self.ticks = self.total + self.D

    def f_to_mc(self, i: int) -> tuple[int, int]:
        """``order_f[i]`` -> (microbatch, chunk): groups of P microbatches
        round-robin over the chunks."""
        if self.C == 1:
            return i, 0
        g, r = divmod(i, self.P * self.C)
        return g * self.P + r % self.P, r // self.P

    def fwd(self, s: int, k: int):
        i = k - s
        return self.f_to_mc(i) if 0 <= i < self.total else None

    def bwd(self, s: int, k: int):
        i = k - self.D + s
        if not 0 <= i < self.total:
            return None
        m, c = self.f_to_mc(i)
        return m, self.C - 1 - c

    def z(self, s: int) -> int:
        """The weight gradients stage ``s`` defers under ZB-H1."""
        return min(self.M, self.D - s)

    def w(self, s: int, k: int):
        i = k - s - self.M
        return i if self.zb and 0 <= i < self.z(s) else None

    def sends_act(self, s: int, k: int) -> bool:
        """Stage ``s`` hands an activation on at tick ``k`` (the last
        virtual stage's forward is fused into its backward)."""
        f = self.fwd(s, k)
        return f is not None and not (s == self.P - 1 and f[1] == self.C - 1)

    def sends_cot(self, s: int, k: int) -> bool:
        """Stage ``s`` hands a cotangent back at tick ``k`` (the first
        virtual stage's goes into the embedding)."""
        b = self.bwd(s, k)
        return b is not None and not (s == 0 and b[1] == 0)

    def neighbours(self, s: int) -> tuple:
        """(previous, next) stage: open chain at C = 1, ring otherwise."""
        if self.C > 1:
            return (s - 1) % self.P, (s + 1) % self.P
        return (s - 1 if s > 0 else None,
                s + 1 if s < self.P - 1 else None)

    def schedule(self) -> list[list[Tick]]:
        """Every stage's sub-ticks in clock order."""
        out = []
        for s in range(self.P):
            ticks = []
            for k in range(self.ticks):
                f, b, w = self.fwd(s, k), self.bwd(s, k), self.w(s, k)
                if f is not None:
                    ticks.append(Tick(s, f[0], "F", f[1]))
                if b is not None:
                    ticks.append(Tick(s, b[0], "B", b[1]))
                if w is not None:
                    ticks.append(Tick(s, w, "W"))
            out.append(ticks)
        return out


def _req(tree):
    return {n: t.detach().requires_grad_(True) for n, t in tree.items()}


def _acc(acc, names, grads, rows=None):
    """Add ``grads`` (f32) into the ``acc`` dict, at ``rows`` of each
    stacked leaf; a leaf's first grad allocates its f32 buffer."""
    for n, g in zip(names, grads):
        if rows is None:
            if acc.get(n) is None:
                acc[n] = g.float()
            else:
                acc[n] += g.float()
        else:
            acc[n][rows] += g.float()


def one_f_one_b_stacked(embed_fn, stage_fn, head_loss_fn,
                        embed_params, stacked_params, head_params,
                        micro_inputs, micro_labels, mesh, act,
                        axis: str = "pp", num_chunks: int = 1,
                        zero_bubble: bool = False, seq_axis=None):
    """The executed 1F1B schedule on this rank (its stage ``s`` is its
    ``axis`` coordinate).

    ``embed_fn(ep, ids) -> x`` (stage 0), ``stage_fn(sp, x, chunk) -> y``
    (``sp``: the chunk's rows of each stacked leaf), ``head_loss_fn(hp,
    y, labels) -> scalar`` (the last stage; the microbatch's mean loss).
    ``stacked_params``: this rank's ``[C * Lv, ...]`` leaves, chunk ``c``
    at rows ``c * Lv``, stage-major (virtual stage ``c * P + s``).
    ``micro_inputs`` / ``micro_labels``: M tensors each.  ``act``: a
    tensor shaped like one stage boundary activation (its shape, dtype and
    device).  ``num_chunks`` C > 1 runs VPP (needs ``M % P == 0``);
    ``zero_bubble`` runs ZB-H1 (needs C = 1, no ``seq_axis``, ``M >=
    2(P - 1) + 1``): the B sub-tick of a deferred microbatch computes the
    cotangent the upstream stage waits for only, and its weight gradients
    run at the W tick ``s + M + m``.  Refusals raise ``AssertionError``
    with the reference's messages.

    Returns ``(loss, dep, dsp, dhp)``: the mean loss over the
    microbatches (summed over ``axis``: every stage holds it), and this
    rank's f32 gradient sums, not reduced over any axis: ``dep`` / ``dhp``
    dicts (a leaf None where this stage never touched it), ``dsp`` shaped
    like ``stacked_params``."""
    P, s = mesh.axis_size(axis), mesh.axis_index(axis)
    M, C = len(micro_inputs), num_chunks
    if P <= 1:
        raise AssertionError("one_f_one_b_stacked requires pp > 1")
    if C < 1:
        raise AssertionError()
    if not (C == 1 or M % P == 0):
        raise AssertionError(f"interleaved schedule requires microbatches "
                             f"({M}) % pp ({P}) == 0")
    clock = Clock(P, M, C, zero_bubble)
    if zero_bubble:
        if C != 1:
            raise AssertionError("zero_bubble composes with num_chunks=1 "
                                 "only")
        if seq_axis is not None:
            raise AssertionError(
                "zero_bubble does not compose with a manual seq_axis: the "
                "W sub-tick's stage recompute runs at stage-dependent "
                "ticks, which cannot be made collective-uniform across pp; "
                "use '1f1b'")
        if M < clock.D + 1:
            raise AssertionError(
                f"ZB-H1 needs microbatches ({M}) >= 2*(pp-1)+1 "
                f"({clock.D + 1}): the first idle F-slot must fall after "
                "the matching backward")
    Lv = next(iter(stacked_params.values())).shape[0] // C
    first, last = s == 0, s == P - 1
    prv, nxt = clock.neighbours(s)
    en, hn = sorted(embed_params), sorted(head_params)
    sn = sorted(stacked_params)
    dep, dhp = dict.fromkeys(en), dict.fromkeys(hn)
    dsp = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           for n, t in stacked_params.items()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=act.device)
    TRACE.clear()

    def chunk(c):
        rows = slice(c * Lv, (c + 1) * Lv)
        return rows, _req({n: stacked_params[n][rows] for n in sn})

    def head_loss(hp, sp, x, m, c):
        return head_loss_fn(hp, stage_fn(sp, x, c), micro_labels[m]) / M

    saved, dys = {}, {}
    recv_f = recv_b = None
    for k in range(clock.ticks):
        y = dx = None
        # ---- F: stage 0 chunk 0 embeds (its graph kept for the B),
        # every other (stage, chunk) runs on what the last tick brought
        f = clock.fwd(s, k)
        if f is not None:
            m, c = f
            if first and c == 0:
                ep = _req({n: embed_params[n] for n in en})
                with torch.enable_grad():
                    x_emb = embed_fn(ep, micro_inputs[m])
                saved[(m, c)] = (x_emb.detach(), (ep, x_emb))
            else:
                if recv_f is None:
                    raise RuntimeError(f"stage {s} tick {k}: no activation "
                                       f"arrived for microbatch {m}")
                saved[(m, c)] = (recv_f, None)
            recv_f = None
            if not (last and c == C - 1):
                with torch.no_grad():
                    y = stage_fn({n: stacked_params[n][c * Lv:(c + 1) * Lv]
                                  for n in sn}, saved[(m, c)][0], c)
            TRACE.append(Tick(s, m, "F", c))
        # ---- B: recompute the stage from its saved input, then backward
        b = clock.bwd(s, k)
        if b is not None:
            m, c = b
            deferred = zero_bubble and m < clock.z(s)
            x_in, emb = saved[(m, c)] if deferred else saved.pop((m, c))
            dy, recv_b = recv_b, None
            is_head, is_emb = last and c == C - 1, first and c == 0
            if dy is None and not is_head:
                raise RuntimeError(f"stage {s} tick {k}: no cotangent "
                                   f"arrived for microbatch {m}")
            rows, sp = chunk(c)
            x = x_in.detach().requires_grad_(True)
            with torch.enable_grad():
                if deferred and is_head:    # its W recomputes the loss
                    loss = head_loss(_req({n: head_params[n] for n in hn}),
                                     sp, x, m, c)
                    (dx,) = grad(loss, [x])
                    loss_acc += loss.detach().float()
                elif deferred:
                    dys[m] = dy
                    if not is_emb:          # stage 0 defers all of it
                        (dx,) = grad(stage_fn(sp, x, c), [x], dy)
                elif is_head:
                    hp = _req({n: head_params[n] for n in hn})
                    loss = head_loss(hp, sp, x, m, c)
                    gs = grad(loss, [*sp.values(), *hp.values(), x])
                    loss_acc += loss.detach().float()
                    _acc(dsp, sn, gs[:len(sn)], rows)
                    _acc(dhp, hn, gs[len(sn):-1])
                    dx = gs[-1]
                else:
                    gs = grad(stage_fn(sp, x, c), [*sp.values(), x], dy)
                    _acc(dsp, sn, gs[:-1], rows)
                    dx = gs[-1]
                    if is_emb:
                        ep, x_emb = emb
                        _acc(dep, en, grad(x_emb, list(ep.values()), dx))
                        dx = None
            TRACE.append(Tick(s, m, "B", c))
        # ---- W (ZB-H1): the deferred weight gradients of microbatch w
        w = clock.w(s, k)
        if w is not None:
            x_in, emb = saved.pop((w, 0))
            rows, sp = chunk(0)
            with torch.enable_grad():
                if last:
                    hp = _req({n: head_params[n] for n in hn})
                    gs = grad(head_loss(hp, sp, x_in, w, 0),
                              [*sp.values(), *hp.values()])
                    _acc(dsp, sn, gs[:len(sn)], rows)
                    _acc(dhp, hn, gs[len(sn):])
                elif first:
                    x = x_in.detach().requires_grad_(True)
                    gs = grad(stage_fn(sp, x, 0), [*sp.values(), x],
                              dys.pop(w))
                    _acc(dsp, sn, gs[:-1], rows)
                    ep, x_emb = emb
                    _acc(dep, en, grad(x_emb, list(ep.values()), gs[-1]))
                else:
                    _acc(dsp, sn, grad(stage_fn(sp, x_in, 0),
                                       list(sp.values()), dys.pop(w)),
                         rows)
            TRACE.append(Tick(s, w, "W"))
        # ---- the tick's exchange: activations on, cotangents back
        sends = ([(nxt, y, 0)] if y is not None else []) \
            + ([(prv, dx, 1)] if dx is not None else [])
        recvs = []
        if prv is not None and clock.sends_act(prv, k):
            recvs.append((prv, act, 0))
        if nxt is not None and clock.sends_cot(nxt, k):
            recvs.append((nxt, act, 1))
        got = dmesh.exchange(mesh, axis, sends, recvs)
        for (_, _, tag), t in zip(recvs, got):
            if tag == 0:
                recv_f = t
            else:
                recv_b = t
    if saved or dys:
        raise RuntimeError(f"stage {s}: microbatches left unfinished "
                           f"{sorted(saved)} {sorted(dys)}")
    loss = dmesh.all_reduce_(loss_acc, mesh, axis)
    return loss, dep, dsp, dhp
