"""Deterministic fault injection for the serving engine (counterpart of
``paddle_tpu/inference/faults.py``).

``PADDLE_TPU_FAULT_INJECT`` becomes a :class:`FaultPlan` that the engine
polls at its seams, so that its degradation paths (the overload ladder,
preemption, eviction, per-request failure) run under test and not only in
production:

* ``alloc_fail`` (the allocator, ``_alloc_to``): a page grab reports the
  pool dry even when pages are free, which drives the overload ladder
  without a tiny pool;
* ``kernel_error`` (the step's dispatch): raises before the step's first
  launch, so host and device state are untouched and the graceful engine
  retries the step;
* ``nan_logits`` (the sampler): sets a per-slot poison bit that the step
  turns into a genuinely non-finite logits row on the device, so the
  NaN/inf guard is held to the real failure shape (graceful mode only: the
  graceful-off step has no poison operand, and the kind is inert there);
* ``slot_error`` (token banking): raises while one slot's token is banked,
  so a host fault in one request must not take down the batch;
* ``cache_error`` (prefix-cache registration): the graceful engine keeps
  the blocks private and fails no request;
* ``tier_drop`` (the host KV tier's restore, ``_restore_tier_block``):
  the matched tier entry vanishes between match and restore, and the
  engine falls back to prefill for the block with the same tokens.

The replica-scoped kinds (``replica_crash``, ``replica_stall``,
``replica_slow``) and the ``replica`` key belong to a fleet router, which
this port does not have yet: the parse refuses them (a warning, and
injection off), since a clause that nobody polls would make a chaos run's
evidence incomplete.

Grammar (``utils/envflags.env_fault_spec``; a typo warns with a
did-you-mean and disables injection)::

    PADDLE_TPU_FAULT_INJECT="alloc_fail@step=7;nan_logits@slot=2,step=11"

Clause keys: ``step`` (the engine step, 1-based; omitted = any step),
``slot`` / ``rid`` (omitted = the first match polled), ``count`` (firings
before the clause is spent; default 1, ``-1`` = unlimited), and ``p`` with
``seed``: each matching poll fires with probability ``p``, drawn from a
stream seeded by ``seed``, so a random chaos run replays exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["KNOWN_KINDS", "KNOWN_KEYS", "REPLICA_KINDS", "FaultClause",
           "FaultPlan", "FaultInjected"]


class FaultInjected(RuntimeError):
    """Raised at a host-side injection seam (the step's dispatch, token
    banking, cache registration) when a plan clause fires.  A type of its
    own, so that the graceful engine's recovery catches exactly the faults
    the plan injected and never an error the same code raised for real.
    The raise comes before the seam's work: no kernel is launched."""


#: fault kinds the engine polls for
KNOWN_KINDS = frozenset({"alloc_fail", "kernel_error", "nan_logits",
                         "slot_error", "cache_error", "tier_drop"})

#: fleet-scoped kinds, refused by the parse
REPLICA_KINDS = frozenset({"replica_crash", "replica_stall", "replica_slow"})

#: clause keys the grammar accepts
KNOWN_KEYS = frozenset({"step", "slot", "rid", "count", "p", "seed"})


@dataclasses.dataclass
class FaultClause:
    """One parsed clause.  ``count`` falls by one a firing; 0 is spent,
    -1 never is."""

    kind: str
    step: int | None = None
    slot: int | None = None
    rid: int | None = None
    count: int = 1
    p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        # a seeded stream of its own: a random clause replays whatever the
        # other clauses draw
        self._rng = np.random.RandomState(self.seed)

    def matches(self, kind: str, step, slot, rid) -> bool:
        if self.kind != kind or self.count == 0:
            return False
        if self.step is not None and step != self.step:
            return False
        if self.slot is not None and slot != self.slot:
            return False
        if self.rid is not None and rid != self.rid:
            return False
        return True


class FaultPlan:
    """The engine's injector: ``fire(kind, ...)`` at a seam is True when a
    clause matches (and spends one firing).  An empty plan is inert: the
    polls return at once."""

    def __init__(self, clauses=()):
        self._clauses = [c if isinstance(c, FaultClause) else FaultClause(**c)
                         for c in clauses]

    @classmethod
    def from_env(cls) -> "FaultPlan":
        """Parse ``PADDLE_TPU_FAULT_INJECT`` (a malformed plan, or one that
        names a fleet's vocabulary, warns once and disables injection)."""
        from ..utils.envflags import env_fault_spec

        return cls(env_fault_spec("PADDLE_TPU_FAULT_INJECT", KNOWN_KINDS,
                                  KNOWN_KEYS,
                                  fleet_only_kinds=REPLICA_KINDS,
                                  fleet_only_keys=frozenset({"replica"})))

    def __bool__(self) -> bool:
        return bool(self._clauses)

    def fire(self, kind: str, *, step: int | None = None,
             slot: int | None = None, rid: int | None = None) -> bool:
        """Poll one seam: True exactly when a clause matches and fires.  The
        engine polls in a fixed order, so a clause with no ``slot`` fires
        on the first matching poll and the plan replays."""
        for c in self._clauses:
            if not c.matches(kind, step, slot, rid):
                continue
            if c.p < 1.0 and float(c._rng.random_sample()) >= c.p:
                continue
            if c.count > 0:
                c.count -= 1
            return True
        return False
