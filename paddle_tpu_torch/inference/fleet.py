"""Fleet serving: a health-checked, prefix-affinity router over N engine
replicas (counterpart of ``paddle_tpu/inference/fleet.py``).

:class:`FleetRouter` is a deterministic in-process fleet: one host control
plane in front of N :class:`~.serving.ContinuousBatchingEngine` replicas,
built on two things the engine already has:

* the prefix cache's hash-chained block ids are a *global* content
  address: the same prompt hashes to the same chain on every replica, so
  "which replica holds this prefix" is a host lookup
  (``PrefixCache.match``, which touches no refcount);
* the journal resumes accepted work by teacher-forced recompute, token for
  token for greedy and seeded sampling, so losing a replica's KV pool
  loses bytes, never streams.

**Routing.**  A prompt goes to the replica holding the longest cached
chain of its blocks (prefix affinity), else to the least-loaded one.
Health comes first: a DEGRADED replica is chosen only when no HEALTHY one
can take the work.  Admission layers on each engine's ``max_queue``: a
replica whose queue is full is not routable, and when every routable
replica is full the fleet sheds the request as REJECTED
(``stats["fleet_rejected"]``).

**Health and failover.**  Replicas walk ``HEALTHY -> DEGRADED -> DRAINING
-> DEAD`` (``HEALTH_EDGES``), driven by per-step heartbeats and faults:

* a streak of ``replica_slow`` heartbeats degrades; a clean streak heals;
* ``drain(r)``: the replica takes no new work but steps until its
  in-flight requests finish;
* a replica that makes no progress for ``stall_steps`` fleet steps while
  holding live work is stalled: its requests are hedge-dispatched onto
  survivors by journal replay, the primary stays the owner until
  first-writer-wins resolves (whichever copy first extends the stream
  owns it; the other is cancelled, so a late answer is never banked
  twice), and at ``stall_dead_steps`` the replica is declared DEAD;
* a DEAD replica (``replica_crash``, or an exception out of its
  ``step()``: on the card, a kernel that failed to launch) fails over:
  its journal is replayed onto the survivors through ``engine.adopt()``.
  Each replayed stream completes as the uninterrupted fleet's would,
  since it depends only on its own ``(seed, position)`` keys and tokens.
  Replayed and hedged work is exempt from backpressure, and deadlines
  re-arm with the journaled remaining budget.

**Chaos.**  ``PADDLE_TPU_FAULT_INJECT`` takes the replica-scoped kinds
(``faults.REPLICA_KINDS``: ``replica_crash`` / ``replica_stall`` /
``replica_slow`` with ``step`` / ``replica`` / ``count`` / ``p`` + ``seed``),
polled once a replica a fleet step in replica order, so a random chaos
run replays from its env string.  The engine-scoped kinds of a fleet plan
fan out to every replica's own plan (``replica=k`` scopes one).

With ``enable_host_kv_tier=True`` the replicas share ONE
:class:`~.kv_tier.HostKVTier`: a chain any replica demoted can be
re-admitted by every other (``cross_readmits``).

The engines keep ``params`` by reference, so N replicas of a bf16 model
cost one weight set and N KV pools.  Under ``quant=`` each engine
quantizes its own copy at construction, as the reference's does.

What the router does not do: move live KV bytes between replicas
(failover replays the journal; the shared tier moves finished,
content-addressed pages), rebalance running work, or distrust its own
clock (one process).  The reference's ``RecordEvent`` spans around
rejection, failover and hedging are not ported (``profiler.py`` keeps the
host trace buffer only); the router's flow links and health markers go
into that buffer through the per-replica tracers.

Audited invariant I9 (``PADDLE_TPU_ENGINE_AUDIT=1``,
``analysis/engine_audit.audit_fleet``, after every fleet step): every
live rid is owned by exactly one replica, a hedge-pending rid counting as
its primary's, and no replica serves a rid the router does not route to
it.  Each replica audits its own I1-I8 and I10 after its steps.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from ..analysis.engine_audit import (EngineAuditError, audit_enabled,
                                     audit_fleet)
from ..utils.envflags import env_bool
from .faults import REPLICA_KINDS, FaultPlan
from .kv_tier import HostKVTier
from .observability import (FLEET_STAT_SCHEMA, FlightRecorder,
                            MetricsRegistry, RequestTracer, SLOTracker,
                            StatsView, flight_recorder_enabled,
                            metrics_enabled)
from .serving import (TERMINAL_STATUSES, ContinuousBatchingEngine, Request,
                      journal_entry)

__all__ = ["FleetRouter", "REPLICA_STATES", "HEALTH_EDGES"]

#: replica health states, in degradation order
REPLICA_STATES = ("HEALTHY", "DEGRADED", "DRAINING", "DEAD")

#: the replica-health transitions: down the ladder, plus the one heal edge
#: DEGRADED -> HEALTHY after ``heal_after`` clean heartbeats; DEAD is
#: absorbing.  DRAINING -> DEAD is a replica killed mid-drain
HEALTH_EDGES = frozenset({
    ("HEALTHY", "DEGRADED"), ("DEGRADED", "HEALTHY"),
    ("HEALTHY", "DRAINING"), ("DEGRADED", "DRAINING"),
    ("HEALTHY", "DEAD"), ("DEGRADED", "DEAD"), ("DRAINING", "DEAD"),
})


class FleetRouter:
    """A deterministic in-process fleet of ``n_replicas`` engines behind
    one cache-aware, health-checked router (module docstring).

    ``engine_kw`` passes through to every engine (``device`` included:
    the replicas run on the card unless the caller names the CPU, and on
    a machine with no card they raise as the engine does).  ``params`` is
    shared by reference.

    ``stall_steps``: fleet steps without progress (while holding live
    work) before a replica counts as stalled and its requests hedge onto
    survivors; at ``stall_dead_steps`` it is declared DEAD, so work that
    cannot be hedged fails with a diagnosis instead of hanging the serve
    loop.  ``slow_after`` / ``heal_after``: slow / clean heartbeats in a
    row before DEGRADED / back to HEALTHY.

    Needs graceful mode (``PADDLE_TPU_GRACEFUL=1``, the default): failover,
    hedging and draining are built on its status lifecycle and
    ``cancel()``."""

    def __init__(self, cfg, params, n_replicas: int = 2, *,
                 stall_steps: int = 3, stall_dead_steps: int = 12,
                 slow_after: int = 2, heal_after: int = 2, **engine_kw):
        if int(n_replicas) < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.n_replicas = int(n_replicas)
        self.stall_steps = int(stall_steps)
        self.stall_dead_steps = int(stall_dead_steps)
        if self.stall_dead_steps <= self.stall_steps:
            raise ValueError(
                f"stall_dead_steps ({stall_dead_steps}) must exceed "
                f"stall_steps ({stall_steps}): hedging must get a chance "
                f"before the replica is declared dead")
        self.slow_after = int(slow_after)
        self.heal_after = int(heal_after)
        # ONE shared registry: every replica registers the same families
        # under a {"replica": k} label, so metrics.expose() is the whole
        # fleet; the router's own stats, SLO and flight tiers sit on top
        # with fleet-prefixed names.  Metrics off: None (absent evidence
        # reads as absent).  The router owns the replica label
        self._metrics_on = metrics_enabled()
        self.metrics = engine_kw.pop("metrics", None)
        if self.metrics is None and self._metrics_on:
            self.metrics = MetricsRegistry()
        engine_kw.pop("metrics_labels", None)
        # the shared host tier: chain hashes are already the routing key,
        # so a chain any replica demoted is re-admittable by every other.
        # shared=True keeps entries resident on ship_in and relaxes I10's
        # exclusivity to per-replica accounting.  The kill switch drops
        # even a tier the caller passed (left unmutated), so
        # ``host_tier is None`` means the tier is off
        self.host_tier = engine_kw.pop("host_tier", None)
        if not env_bool("PADDLE_TPU_HOST_KV_TIER", True):
            self.host_tier = None
        elif self.host_tier is not None:
            self.host_tier.shared = True
        elif engine_kw.get("enable_host_kv_tier"):
            self.host_tier = HostKVTier(shared=True)
        if self.host_tier is not None:
            engine_kw["host_tier"] = self.host_tier
        # the engines must not parse a fleet plan themselves (a replica
        # clause would, rightly, turn their whole plan off): the router
        # parses once with the full vocabulary and installs each replica's
        # engine-scoped share (_arm_faults_from_env)
        spec = os.environ.pop("PADDLE_TPU_FAULT_INJECT", None)
        try:
            self.replicas: list[ContinuousBatchingEngine | None] = [
                ContinuousBatchingEngine(cfg, params, metrics=self.metrics,
                                         metrics_labels={"replica": str(r)},
                                         **engine_kw)
                for r in range(self.n_replicas)]
        finally:
            if spec is not None:
                os.environ["PADDLE_TPU_FAULT_INJECT"] = spec
        if not self.replicas[0]._graceful:
            raise RuntimeError(
                "FleetRouter requires PADDLE_TPU_GRACEFUL=1: failover, "
                "hedging and draining are built on the graceful engine's "
                "status lifecycle and cancel()")
        self.health: list[str] = ["HEALTHY"] * self.n_replicas
        # rid -> the caller's Request, LIVE ones only (terminal requests
        # are pruned, as the engine prunes its own registry)
        self._reqs: dict[int, Request] = {}
        # rid -> owning replica (I9: exactly one owner a live rid)
        self._owner: dict[int, int] = {}
        # rid -> {replica: replica-local copy}; the owner always holds one,
        # a hedge-pending rid a second one on the hedge target
        self._copies: dict[int, dict[int, Request]] = {}
        # rid -> hedge replica (first-writer-wins pending); the primary
        # stays the owner until a copy extends the stream
        self._hedge: dict[int, int] = {}
        # the journal the router replays from, a replica each.  With the
        # async host runtime on, the replicas keep theirs incrementally
        # and the router pulls one only at the boundaries that consume it
        # (death, hedging: _journal_pull), so it stays None until then;
        # off, the router rebuilds it with snapshot() after every step and
        # every dispatch
        self._journal: list[dict | None] = [None] * self.n_replicas
        self._async_host = env_bool("PADDLE_TPU_ASYNC_HOST", True)
        self._last_progress = [0] * self.n_replicas
        self._slow_streak = [0] * self.n_replicas
        self._ok_streak = [0] * self.n_replicas
        self._step_no = 0          # fleet step counter (replica-clause key)
        # fleet stats over the shared registry behind the engines' dict
        # view (keys and help: FLEET_STAT_SCHEMA); PADDLE_TPU_METRICS=0
        # gives the plain dict.  The SLO tracker is fed in _mirror with the
        # same timestamps that set each request's ttft_s
        if self._metrics_on:
            self.stats = StatsView(self.metrics, FLEET_STAT_SCHEMA,
                                   prefix="paddle_tpu_fleet")
            self.slo = SLOTracker(self.metrics, prefix="paddle_tpu_fleet")
            self._h_jupdate = self.metrics.histogram(
                "paddle_tpu_fleet_journal_update_seconds",
                "Host seconds per router journal refresh: async-on, one "
                "incremental pull per consumption boundary (failover/"
                "hedge); async-off, one full snapshot() rebuild per step "
                "and per dispatch — the critical-path journal tax "
                "(docs/async_runtime.md)"
            ).labels()
        else:
            self.stats = {k: 0 for k in FLEET_STAT_SCHEMA}
            self.slo = None
            self._h_jupdate = None
        # one flow-link tracer a replica lane (the engines' own tracers
        # carry the spans; the router adds the failover / hedge arrows
        # and the health markers)
        self._tracers = [RequestTracer(enabled=self._metrics_on, pid=r)
                         for r in range(self.n_replicas)]
        self._flow_seq = 0
        self._flight = (FlightRecorder(registry=(self.metrics
                                                 if self._metrics_on
                                                 else None), name="fleet")
                        if flight_recorder_enabled() else None)
        self._faults = FaultPlan()
        self._arm_faults_from_env()
        self._audit_every_step = audit_enabled()

    # ---------------- chaos plumbing ----------------

    def _arm_faults_from_env(self) -> None:
        """Parse ``PADDLE_TPU_FAULT_INJECT`` with the fleet's vocabulary
        and split it: replica-scoped clauses arm the router's plan, the
        engine-scoped ones each replica's (a clause with ``replica=k`` only
        replica k's, one without it every replica's, each with a state of
        its own so counts and seeded draws stay per replica)."""
        clauses = FaultPlan.from_env(fleet=True)._clauses
        self._faults = FaultPlan(
            [c for c in clauses if c.kind in REPLICA_KINDS])
        eng_clauses = [c for c in clauses if c.kind not in REPLICA_KINDS]
        for r, eng in enumerate(self.replicas):
            if eng is None:
                continue
            # the engine's polls pass no replica: strip the scope so the
            # clause matches its engine's seams (``replace`` builds a fresh
            # clause, its count and seeded stream its own)
            eng._faults = FaultPlan(
                [dataclasses.replace(c, replica=None) for c in eng_clauses
                 if c.replica in (None, r)])

    # ---------------- routing ----------------

    def _load(self, r: int) -> int:
        """Live accepted requests (running + queued) on replica ``r``."""
        return len(self.replicas[r]._reqs)

    def _full(self, r: int) -> bool:
        eng = self.replicas[r]
        return (eng.max_queue is not None
                and len(eng._queue) >= eng.max_queue)

    def _match_len(self, r: int, ids: np.ndarray) -> int:
        """Full blocks of this stream replica ``r`` holds cached (the
        global content address the router keys on; ``match`` touches no
        refcount)."""
        pc = self.replicas[r]._pcache
        return len(pc.match(ids)) if pc is not None else 0

    def _route(self, ids: np.ndarray, exclude=frozenset(),
               accepted: bool = False) -> tuple[int | None, int]:
        """The target replica for a stream: HEALTHY before DEGRADED, then
        the longest cached chain, then the least-loaded, then the lowest
        index (fully deterministic).  ``accepted=True`` (failover replay,
        hedging) lifts the queue-full filter, since accepted work is never
        rejected, and falls back to a DRAINING replica when nothing else
        survives (delaying a drain beats dropping accepted work).  Returns
        (replica or None, match length)."""
        alive = [r for r in range(self.n_replicas)
                 if self.replicas[r] is not None and r not in exclude]
        cands = [r for r in alive if self.health[r] in ("HEALTHY",
                                                        "DEGRADED")]
        if not accepted:
            cands = [r for r in cands if not self._full(r)]
        elif not cands:
            cands = [r for r in alive if self.health[r] == "DRAINING"]
        if not cands:
            return None, 0
        match = {r: self._match_len(r, ids) for r in cands}
        best = min(cands, key=lambda r: (
            0 if self.health[r] == "HEALTHY" else 1,
            -match[r], self._load(r), r))
        return best, match[best]

    def _reject(self, req: Request, msg: str) -> None:
        req.status = "REJECTED"
        req.finished = True
        req.error = msg
        self.stats["fleet_rejected"] += 1
        if self.slo is not None:
            self.slo.finish(req.rid, "REJECTED", time.perf_counter())
        if self._flight is not None:
            self._flight.record("terminal", rid=req.rid, status="REJECTED",
                                error=msg)

    @staticmethod
    def _copy_req(req: Request) -> Request:
        """A replica-local twin of a fleet request: the same rid and
        sampling parameters, so the engine's default ``seed = rid`` and its
        ``(seed, position)`` keys draw the same stream on every replica
        (what makes hedging and failover token-identical)."""
        return Request(
            rid=req.rid,
            prompt_ids=np.asarray(req.prompt_ids, np.int32).ravel(),
            max_new_tokens=req.max_new_tokens,
            eos_token_id=req.eos_token_id,
            temperature=req.temperature, top_p=req.top_p, seed=req.seed,
            deadline_s=req.deadline_s, trace_id=req.trace_id)

    def add_request(self, req: Request) -> None:
        """Route one request into the fleet, or shed it as REJECTED when
        no routable replica can take it (fleet backpressure) or it is
        invalid (one bad request never raises out of the router)."""
        if req.rid in self._reqs:
            raise ValueError(f"request {req.rid}: rid already live in the "
                             f"fleet")
        req._submit_s = time.perf_counter()
        if req.trace_id is None:
            req.trace_id = f"req-{req.rid:x}"
        if self.slo is not None:
            self.slo.begin(req.rid, req._submit_s)
        probe = next((e for e in self.replicas if e is not None), None)
        if probe is None:
            self._reject(req, "every replica is DEAD (fleet lost)")
            return
        try:
            probe._validate(req)
        except ValueError as e:
            self._reject(req, str(e))
            return
        ids = np.asarray(req.prompt_ids, np.int32).ravel()
        target, m = self._route(ids)
        if target is None:
            # name the actual cause: an operator who drained the whole
            # fleet must not be sent to debug max_queue
            routable = [r for r in range(self.n_replicas)
                        if self.replicas[r] is not None
                        and self.health[r] in ("HEALTHY", "DEGRADED")]
            if routable:
                msg = ("fleet backpressure: every routable replica's "
                       "queue is full")
            else:
                n_drain = self.health.count("DRAINING")
                n_dead = self.health.count("DEAD")
                msg = (f"no routable replica: {n_drain} DRAINING, "
                       f"{n_dead} DEAD of {self.n_replicas} (draining "
                       f"replicas accept no new work)")
            self._reject(req, msg)
            return
        self.stats["routed_affinity" if m > 0 else "routed_spill"] += 1
        if self._flight is not None:
            self._flight.record("route", rid=req.rid, replica=target,
                                match_blocks=int(m))
        copy = self._copy_req(req)
        self.replicas[target].add_request(copy)
        if copy.status == "REJECTED":       # _route filtered full queues
            self._reject(req, copy.error or "replica rejected the request")
            return
        self._reqs[req.rid] = req
        self._owner[req.rid] = target
        self._copies[req.rid] = {target: copy}
        # a crash before the replica's next step must still replay this
        # request: async off, the router rebuilds the journal now; on, the
        # replica's journal marked the rid and the boundary pulls it
        if not self._async_host:
            t0 = time.perf_counter()
            self.stats["journal_full_rebuilds"] += 1
            self._journal[target] = self.replicas[target].snapshot()
            if self._h_jupdate is not None:
                self._h_jupdate.observe(time.perf_counter() - t0)

    def cancel(self, rid: int) -> bool:
        """Cancel a fleet request: every replica copy (the owner's and a
        pending hedge's) cancels, and the request ends CANCELLED with its
        partial output.  False for an unknown or terminal rid."""
        f = self._reqs.get(rid)
        if f is None:
            return False
        for rr, cc in self._copies.pop(rid, {}).items():
            eng = self.replicas[rr]
            if eng is not None and not cc.finished:
                eng.cancel(rid)
        self._owner.pop(rid, None)
        self._hedge.pop(rid, None)
        self._reqs.pop(rid, None)
        f.status = "CANCELLED"
        f.finished = True
        f.error = "cancelled by caller"
        if self.slo is not None:
            self.slo.finish(rid, "CANCELLED", time.perf_counter())
        return True

    # ---------------- health and failover ----------------

    def drain(self, replica: int) -> None:
        """Mark a replica DRAINING: routing skips it (only a last-resort
        failover replay may land there) while it steps until its
        in-flight requests finish (rolling restart, scale-in)."""
        if self.replicas[replica] is None or self.health[replica] == "DEAD":
            raise ValueError(f"replica {replica} is DEAD")
        self._health_to(replica, "DRAINING", "drain() by operator")

    def _has_live(self, r: int) -> bool:
        eng = self.replicas[r]
        return eng is not None and bool(eng._reqs)

    def _health_to(self, r: int, state: str, why: str) -> None:
        """Every health transition goes through here, so each lands in the
        flight recorder and on the replica's trace lane."""
        prev = self.health[r]
        if prev == state:
            return
        self.health[r] = state
        now = time.perf_counter()
        if self._flight is not None:
            self._flight.record("health", replica=r, frm=prev, to=state,
                                why=why)
        self._tracers[r].instant(0, f"health:{state}", now,
                                 args={"replica": r, "from": prev,
                                       "why": why})

    def _note_heartbeat(self, r: int, ok: bool) -> None:
        """A slow or stalled step degrades after ``slow_after`` in a row; a
        clean streak of ``heal_after`` heals a DEGRADED replica (DRAINING
        and DEAD never heal: an operator's decision, and the end)."""
        if ok:
            self._ok_streak[r] += 1
            self._slow_streak[r] = 0
            if (self.health[r] == "DEGRADED"
                    and self._ok_streak[r] >= self.heal_after):
                self._health_to(r, "HEALTHY",
                                f"{self._ok_streak[r]} clean heartbeats")
        else:
            self._slow_streak[r] += 1
            self._ok_streak[r] = 0
            if (self.health[r] == "HEALTHY"
                    and self._slow_streak[r] >= self.slow_after):
                self._health_to(r, "DEGRADED",
                                f"{self._slow_streak[r]} slow/stalled "
                                f"heartbeats")

    def _journal_pull(self, r: int) -> None:
        """Async host runtime: pull replica ``r``'s incremental journal,
        the O(changed requests) stand-in for per-step ``snapshot()``
        rebuilds, at the boundaries that consume it (death, hedging)."""
        eng = self.replicas[r]
        if eng is None:
            return
        t0 = time.perf_counter()
        self._journal[r] = (eng.journal() if eng._reqs
                            else {"running": [], "queued": []})
        self.stats["journal_incremental_updates"] += 1
        if self._h_jupdate is not None:
            self._h_jupdate.observe(time.perf_counter() - t0)
        if self._flight is not None:
            self._flight.record("journal_pull", replica=r)

    def _audit_journal_equiv(self, r: int) -> None:
        """With the auditor on: replica ``r``'s incremental journal equals
        a fresh ``snapshot()``, the contract failover replays on once the
        router stops rebuilding snapshots.  ``deadline_remaining_s`` is
        left out: each side computes it when read, nanoseconds apart."""
        eng = self.replicas[r]
        if eng is None or not eng._reqs:
            return

        def _norm(d: dict) -> dict:
            return {**d,
                    "running": [dict(e, deadline_remaining_s=None)
                                for e in d["running"]],
                    "queued": [dict(e, deadline_remaining_s=None)
                               for e in d["queued"]]}

        j, s = _norm(eng.journal()), _norm(eng.snapshot())
        if j != s:
            if self._flight is not None:
                self._flight.dump(f"journal_divergence replica={r}")
            raise EngineAuditError(
                f"incremental journal diverged from snapshot() on "
                f"replica {r} (async host runtime): "
                f"journal={j!r} snapshot={s!r}")

    def _journal_entry(self, r: int, rid: int) -> dict:
        """The journal entry to replay for ``rid`` of replica ``r``: the
        pulled journal's, else one built from the fleet's mirrored request
        with the same ``serving.journal_entry`` schema (the same content
        but the prefill cursor, which is provenance only)."""
        j = self._journal[r] or {}
        for e in j.get("running", []) + j.get("queued", []):
            if e["rid"] == rid:
                return e
        return journal_entry(self._reqs[rid])

    def _replay(self, rid: int, entry: dict, exclude: set,
                source: int | None = None,
                link: str = "failover") -> int | None:
        """Adopt one journal entry onto the best survivor (affinity over
        the whole prompt + generated stream: retired generated blocks are
        content-addressed too).  Returns the target, or None when nothing
        survives.  ``source`` (the dead or stalled replica) draws a flow
        arrow from its trace lane to the adopter's, so a failover or hedge
        reads as one request line across the fleet."""
        ids = np.asarray(list(entry["prompt_ids"])
                         + list(entry["output_ids"]), np.int32)
        target, _ = self._route(ids, exclude=exclude, accepted=True)
        if target is None:
            return None
        copy = self.replicas[target].adopt(entry)
        self._copies.setdefault(rid, {})[target] = copy
        self.stats["replayed_tokens"] += len(entry["output_ids"])
        if source is not None:
            now = time.perf_counter()
            self._flow_seq += 1
            fid = f"{link}-{rid}-{self._flow_seq}"
            self._tracers[source].flow_out(rid, link, now, fid)
            self._tracers[target].flow_in(rid, link, now + 1e-6, fid)
        if self._flight is not None:
            self._flight.record(link, rid=rid, frm=source, to=target,
                                replayed_tokens=len(entry["output_ids"]))
        return target

    def _kill(self, r: int, reason: str) -> None:
        """Replica death: mark DEAD, drop the engine and replay its
        journal onto the survivors.  A rid with a pending hedge needs no
        replay (its twin carries the stream and inherits ownership); a rid
        hedged ONTO the dead replica loses the hedge.  With no survivor the
        affected requests end FAILED (the fleet is lost)."""
        dead_eng = self.replicas[r]   # for the flight-recorder dump
        if self._async_host:
            # the death boundary consumes the journal: pull it while the
            # engine is still here
            self._journal_pull(r)
        self._health_to(r, "DEAD", reason)
        self.replicas[r] = None
        self.stats["failovers"] += 1
        for rid, h in list(self._hedge.items()):
            if h == r:                  # the hedge twin died: drop it
                del self._hedge[rid]
                self._copies.get(rid, {}).pop(r, None)
        for rid in [rid for rid, o in list(self._owner.items()) if o == r]:
            self._copies.get(rid, {}).pop(r, None)
            h = self._hedge.pop(rid, None)
            if h is not None:
                # first-writer-wins resolves by default: the survivor is
                # the only writer left
                self._owner[rid] = h
                continue
            entry = self._journal_entry(r, rid)
            target = self._replay(rid, entry, exclude={r}, source=r)
            if target is None:
                f = self._reqs.pop(rid)
                self._owner.pop(rid, None)
                self._copies.pop(rid, None)
                f.status = "FAILED"
                f.finished = True
                f.error = (f"replica {r} died ({reason}) with no "
                           f"surviving replica to replay onto")
                if self.slo is not None:
                    self.slo.finish(rid, "FAILED", time.perf_counter())
                continue
            self._owner[rid] = target
        # a death dumps the flight recorder: the router's recent events,
        # the dead replica's own ring and a fleet metrics snapshot
        if self._flight is not None:
            self._flight.dump(
                f"replica {r} DEAD: {reason}",
                extra={"replica": r,
                       "engine_events": (
                           dead_eng._flight.events()
                           if dead_eng is not None
                           and dead_eng._flight is not None else None)})
        # every live entry is replayed: keeping the dead replica's journal
        # would hold its requests' token lists for the router's lifetime
        self._journal[r] = None

    def _detect_stalls(self) -> None:
        """Heartbeat-gap stall detection: a replica holding live work that
        has not completed a step for ``stall_steps`` fleet steps has its
        requests hedged onto survivors (the primary stays the owner, I9,
        until ``_mirror`` resolves first-writer-wins).  A stall that
        reaches ``stall_dead_steps`` is a crash: the replica is declared
        DEAD, so work with nowhere to go ends FAILED instead of spinning
        ``serve()`` forever (deadlines cannot end it either: expiry runs
        inside the step the stalled replica never takes)."""
        for r in range(self.n_replicas):
            if self.replicas[r] is None or not self._has_live(r):
                continue
            gap = self._step_no - self._last_progress[r]
            if gap < self.stall_steps:
                continue
            if gap >= self.stall_dead_steps:
                self._kill(r, f"stalled for {gap} fleet steps "
                              f"(stall_dead_steps={self.stall_dead_steps})")
                continue
            if self.health[r] == "HEALTHY":
                self._health_to(r, "DEGRADED",
                                f"no progress for {gap} fleet steps")
            if self._async_host:
                # the hedge boundary: refresh the stalled replica's journal
                # (its host side answers; its device step does not)
                self._journal_pull(r)
            for rid in [rid for rid, o in self._owner.items() if o == r]:
                if rid in self._hedge:
                    continue               # already hedge-pending
                entry = self._journal_entry(r, rid)
                target = self._replay(rid, entry, exclude={r}, source=r,
                                      link="hedge")
                if target is None:
                    continue               # nobody to hedge onto: wait
                self._hedge[rid] = target
                self.stats["hedges"] += 1

    def _resolve_hedge(self, rid: int, winner: int) -> None:
        """First-writer-wins: ``winner`` extended the stream first and
        owns it; the loser's copy is cancelled (its late answer, the same
        tokens by the determinism contract, is discarded and its pages
        freed)."""
        h = self._hedge.pop(rid)
        owner = self._owner[rid]
        loser = owner if winner == h else h
        self._owner[rid] = winner
        cc = self._copies.get(rid, {}).pop(loser, None)
        eng = self.replicas[loser]
        if cc is not None and eng is not None and not cc.finished:
            eng.cancel(rid)

    def _promote(self, rid: int, new_owner: int) -> None:
        """The primary ended on its own (its engine failed the copy) while
        a hedge twin is mid-replay: the twin owns the request instead of
        the fleet request failing."""
        old = self._owner[rid]
        self._copies.get(rid, {}).pop(old, None)
        self._owner[rid] = new_owner

    def _finish(self, rid: int, copy: Request) -> None:
        """Mirror a terminal replica copy onto the fleet request and prune
        every live registry (I9: terminal is gone from the routing plane);
        any other copy still live (an unresolved hedge twin) cancels."""
        f = self._reqs.pop(rid)
        self._hedge.pop(rid, None)
        self._owner.pop(rid, None)
        for rr, cc in self._copies.pop(rid, {}).items():
            if cc is copy:
                continue
            eng = self.replicas[rr]
            if eng is not None and not cc.finished:
                eng.cancel(rid)
        f.status = copy.status
        f.finished = True
        f.error = copy.error
        if self.slo is not None:
            self.slo.finish(rid, copy.status, time.perf_counter())

    def _mirror(self, r: int) -> None:
        """After replica ``r`` steps: bank its copies' new tokens onto the
        fleet requests (resolving first-writer-wins for hedge-pending
        rids) and mirror terminal statuses."""
        for rid in [rid for rid in list(self._reqs)
                    if self._owner.get(rid) == r
                    or self._hedge.get(rid) == r]:
            f = self._reqs.get(rid)
            c = self._copies.get(rid, {}).get(r)
            if f is None or c is None:
                continue
            if len(c.output_ids) > len(f.output_ids):
                if rid in self._hedge:
                    self._resolve_hedge(rid, winner=r)
                delta = len(c.output_ids) - len(f.output_ids)
                f.output_ids.extend(c.output_ids[len(f.output_ids):])
                now = time.perf_counter()
                if f.ttft_s is None:
                    # the fleet's TTFT: routing, queueing and (on failover)
                    # the replay's recompute included
                    f.ttft_s = now - f._submit_s
                if self.slo is not None:
                    # the same ``now`` that stamps ttft_s
                    self.slo.tokens(rid, delta, now)
            if self._owner.get(rid) != r:
                # a hedge twin that has not won: its own terminal status
                # (failed or expired on the hedge target) drops the hedge
                if c.status in TERMINAL_STATUSES:
                    self._hedge.pop(rid, None)
                    self._copies.get(rid, {}).pop(r, None)
                continue
            if c.status in TERMINAL_STATUSES and c.status != "CANCELLED":
                if c.status != "FINISHED" and rid in self._hedge:
                    self._promote(rid, self._hedge.pop(rid))
                else:
                    self._finish(rid, c)
            elif not c.finished:
                f.status = c.status        # PENDING / RUNNING, as observed

    def step(self) -> bool:
        """One fleet round: poll the replica-scoped chaos, step every live
        replica once in replica order (the clock every clause keys on),
        mirror outputs, refresh journals, advance health and hedge stalled
        work.  Returns False when the whole fleet is idle."""
        self._step_no += 1
        busy = False
        stepped_any = False
        for r in range(self.n_replicas):
            if self.replicas[r] is None:
                continue
            if self._faults and self._faults.fire(
                    "replica_crash", step=self._step_no, replica=r):
                self._kill(r, f"injected replica_crash (fleet step "
                              f"{self._step_no})")
                busy = True
                continue
            stalled = bool(self._faults) and self._faults.fire(
                "replica_stall", step=self._step_no, replica=r)
            # a stalled step already misses its heartbeat: polling the
            # slow clause too would spend its count where it has no effect
            slow = (not stalled and bool(self._faults)
                    and self._faults.fire("replica_slow",
                                          step=self._step_no, replica=r))
            if stalled:
                # the step "hangs": no progress, no heartbeat, no journal
                # refresh, what the router sees of a wedged device
                self._note_heartbeat(r, ok=False)
                busy = busy or self._has_live(r)
                continue
            eng = self.replicas[r]
            try:
                stepped = eng.step()
            except Exception as e:
                # a fault that escapes the graceful engine's step() (a
                # kernel that failed to launch, an audit violation) is the
                # replica's death, not the router's crash
                self._kill(r, f"engine fault escaped step(): {e}")
                busy = True
                continue
            self._last_progress[r] = self._step_no
            self._note_heartbeat(r, ok=not slow)
            self._mirror(r)
            if self._async_host:
                # the replica flushed its journal in its own launch window;
                # the router reads it only at a death or hedge boundary
                stepped_any = True
                if self._audit_every_step:
                    self._audit_journal_equiv(r)
            elif eng._reqs:
                # async off: a full snapshot() a replica a step, the price
                # of a journal never a step stale at a death (timed into
                # the journal histogram: the tax the async runtime removes)
                t0 = time.perf_counter()
                self.stats["journal_full_rebuilds"] += 1
                self._journal[r] = eng.snapshot()
                if self._h_jupdate is not None:
                    self._h_jupdate.observe(time.perf_counter() - t0)
            else:
                self._journal[r] = {"running": [], "queued": []}
            busy = busy or stepped or self._has_live(r)
        if self._async_host and stepped_any:
            self.stats["host_overlap_steps"] += 1
        self._detect_stalls()
        if self._audit_every_step:
            try:
                audit_fleet(self)
            except EngineAuditError:
                if self._flight is not None:
                    self._flight.dump("fleet_audit_error")
                raise
        return busy or bool(self._reqs)

    def export_trace(self, path: str) -> None:
        """Write (and drain) the buffered host spans as ONE chrome trace:
        every replica's request spans plus the router's failover / hedge
        flow links and health markers; pid = replica lane, tid = request
        lane."""
        from ..profiler import Profiler

        Profiler().export(path)

    # ---------------- serve loop ----------------

    def serve(self, requests: list[Request]) -> dict[int, list[int]]:
        """Route and run every request to its end; returns ``{rid:
        generated tokens}`` (the fleet's mirrored streams)."""
        for r in requests:
            self.add_request(r)
        while self.step():
            pass
        return {r.rid: r.output_ids for r in requests}
