"""Serving observability (counterpart of
``paddle_tpu/inference/observability.py``): typed metrics, request
lifecycle tracing, streaming SLO accounting and a fault flight recorder
for the continuous-batching engine.

* :class:`MetricsRegistry`: typed counters, gauges and fixed-log2-bucket
  streaming histograms with labels, and Prometheus-style text exposition
  (:meth:`MetricsRegistry.expose`).  The engine's ``stats`` lives on it
  behind :class:`StatsView`, a dict-compatible view, so every
  ``eng.stats["decode_tokens"]`` read keeps working while the same counter
  shows up labelled in the exposition.
* :class:`RequestTracer`: per-request lifecycle spans (queued, prefill or
  prefill chunks, decode, the terminal marker) into the port's host trace
  buffer (``paddle_tpu_torch/profiler.py``), exported as one chrome trace
  (pid = replica, tid = request id).
* :class:`SLOTracker`: streaming per-request TTFT / TBT / queue-wait
  accounting from the same host events, and :meth:`SLOTracker.goodput_at`.
* :class:`FlightRecorder`: a bounded ring of recent engine events
  (admissions, ladder rungs, faults, evictions, step packing) dumped with
  a metrics snapshot when a request FAILs.

The schemas :data:`ENGINE_STAT_SCHEMA` and :data:`FLEET_STAT_SCHEMA` are
the reference's, key for key.

The recording contract
----------------------
All recording is host-side, before a step's launches or after its one
host fetch, never between them: no metric, span or flight record adds a
device sync, and token streams are identical with observability on or
off.  Each record is O(1) host work.

Switches (``utils/envflags.py``): ``PADDLE_TPU_METRICS=0`` restores the
plain stats dict (no registry, no spans, no SLO tracking);
``PADDLE_TPU_FLIGHT_RECORDER=0`` disables the ring and its dumps.
"""

from __future__ import annotations

import json
import math
import time
from collections import deque
from collections.abc import MutableMapping

__all__ = [
    "MetricsRegistry", "StatsView", "SLOTracker", "FlightRecorder",
    "RequestTracer", "ENGINE_STAT_SCHEMA", "FLEET_STAT_SCHEMA",
    "metrics_enabled", "flight_recorder_enabled",
]


def metrics_enabled() -> bool:
    """``PADDLE_TPU_METRICS`` (default on): the registry, tracing and SLO
    accounting.  ``=0`` restores the plain stats dict."""
    from ..utils.envflags import env_bool

    return env_bool("PADDLE_TPU_METRICS", True)


def flight_recorder_enabled() -> bool:
    """``PADDLE_TPU_FLIGHT_RECORDER`` (default on): the bounded event ring
    buffer and its failure-triggered dumps."""
    from ..utils.envflags import env_bool

    return env_bool("PADDLE_TPU_FLIGHT_RECORDER", True)


# ---------------------------------------------------------------- metrics

def _fmt(v) -> str:
    """Prometheus sample value: integral values print as integers so
    counter exposition stays diff-stable across int/float promotion."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float) and v.is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(v)


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + body + "}"


class _Value:
    """One labelled counter/gauge child.  ``value`` stays a plain Python
    number (int counters keep int-ness — ``dict(stats)`` equality across
    identical runs must hold exactly)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def set(self, v):
        self.value = v


class _HistValue:
    """One labelled histogram child: fixed log2 buckets (upper bounds
    ``2**lo .. 2**hi`` plus +Inf).  ``observe`` is O(1) — a frexp, two
    clamps and three increments — so it is safe on the per-step host
    path."""

    __slots__ = ("counts", "sum", "count", "_lo", "_n")

    def __init__(self, lo: int, hi: int):
        self._lo = lo
        self._n = hi - lo + 2          # 2**lo .. 2**hi, then +Inf
        self.counts = [0] * self._n
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        v = float(v)
        if v <= 0.0 or v != v:          # <=0 and NaN land in the first bucket
            idx = 0
        elif v == math.inf:
            idx = self._n - 1
        else:
            m, e = math.frexp(v)        # v = m * 2**e, m in [0.5, 1)
            ub = e - 1 if m == 0.5 else e   # smallest k with v <= 2**k
            idx = min(max(ub - self._lo, 0), self._n - 1)
        self.counts[idx] += 1
        self.sum += v
        self.count += 1

    def buckets(self, lo: int):
        """(upper-bound-label, cumulative-count) pairs, Prometheus order."""
        out, cum = [], 0
        for i, c in enumerate(self.counts):
            cum += c
            le = "+Inf" if i == self._n - 1 else _fmt(2.0 ** (lo + i))
            out.append((le, cum))
        return out


class MetricFamily:
    """One named metric (counter | gauge | histogram) and its labelled
    children.  Obtained via the registry's :meth:`MetricsRegistry.counter`
    / ``gauge`` / ``histogram`` — re-registering the same name returns the
    SAME family (how N fleet replicas share one exposition), and a
    kind/help mismatch raises instead of silently forking the metric."""

    def __init__(self, name: str, help: str, kind: str, lo: int = -20,
                 hi: int = 6):
        self.name = name
        self.help = help
        self.kind = kind
        self.lo, self.hi = lo, hi
        self._children: dict[tuple, object] = {}

    def labels(self, **kv):
        key = tuple(sorted((k, str(v)) for k, v in kv.items()))
        child = self._children.get(key)
        if child is None:
            child = (_HistValue(self.lo, self.hi) if self.kind == "histogram"
                     else _Value())
            self._children[key] = child
        return child

    def expose_into(self, lines: list[str]):
        lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._children):
            child = self._children[key]
            if self.kind == "histogram":
                for le, cum in child.buckets(self.lo):
                    lab = _label_str(key + (("le", le),))
                    lines.append(f"{self.name}_bucket{lab} {cum}")
                lines.append(f"{self.name}_sum{_label_str(key)} "
                             f"{_fmt(child.sum)}")
                lines.append(f"{self.name}_count{_label_str(key)} "
                             f"{child.count}")
            else:
                lines.append(f"{self.name}{_label_str(key)} "
                             f"{_fmt(child.value)}")


class MetricsRegistry:
    """Typed metric registry with Prometheus-style text exposition.

    One registry per engine by default; engines handed ONE registry with
    a ``{"replica": k}`` label set each (the engine's ``metrics`` /
    ``metrics_labels`` arguments) share one exposition.  Single-threaded
    by design (the engine is one host control plane); nothing here takes
    a lock."""

    def __init__(self):
        self._families: dict[str, MetricFamily] = {}

    def _register(self, kind: str, name: str, help: str, **kw) -> MetricFamily:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"cannot re-register as {kind}")
            return fam
        if not help:
            raise ValueError(f"metric {name!r} needs a non-empty help "
                             f"string (the exposition contract)")
        fam = MetricFamily(name, help, kind, **kw)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str) -> MetricFamily:
        return self._register("counter", name, help)

    def gauge(self, name: str, help: str) -> MetricFamily:
        return self._register("gauge", name, help)

    def histogram(self, name: str, help: str, lo: int = -20,
                  hi: int = 6) -> MetricFamily:
        """Fixed log2 buckets: upper bounds ``2**lo .. 2**hi`` seconds (or
        whatever unit the caller observes) plus +Inf.  The defaults span
        ~1 microsecond to 64 s — the whole serving latency range."""
        return self._register("histogram", name, help, lo=lo, hi=hi)

    def describe(self) -> dict[str, str]:
        """{metric name: help} — the introspection surface the stat-schema
        test audits (every counter a test or bench reads must be here)."""
        return {n: f.help for n, f in sorted(self._families.items())}

    def expose(self) -> str:
        """Prometheus text exposition of every family, name-sorted — the
        snapshot bench rungs embed and flight-recorder dumps attach."""
        lines: list[str] = []
        for name in sorted(self._families):
            self._families[name].expose_into(lines)
        return "\n".join(lines) + ("\n" if lines else "")


# ------------------------------------------------- stats-dict migration

#: engine ``stats`` keys -> (metric kind, help): the reference's schema,
#: copied whole (help strings included), so the two packages expose the
#: same metric families.  The ``tier_*``, ``journal_*`` and
#: ``host_overlap_steps`` keys belong to the host KV tier and the journal,
#: which the port does not have yet: its engine keeps them at 0.
ENGINE_STAT_SCHEMA = {
    "decode_steps": ("counter", "Compiled decode/verify/mixed step "
                                "iterations executed"),
    "decode_tokens": ("counter", "Generated tokens actually delivered to "
                                 "callers (post EOS/budget trimming)"),
    "prefills": ("counter", "Whole-prompt (bucketed or partial-bucket) "
                            "prefill launches"),
    "decode_time_s": ("gauge", "Wall seconds spent in compiled serving "
                               "steps (decode_tokens / this = tok/s)"),
    "preemptions": ("counter", "vLLM-style recompute preemptions (pool "
                               "pressure victims)"),
    "prefix_hits": ("counter", "Admissions that mapped at least one cached "
                               "prefix block"),
    "prefix_blocks_reused": ("counter", "Cached KV blocks mapped read-only "
                                        "into admissions"),
    "prefix_evictions": ("counter", "Zero-ref cached blocks LRU-evicted "
                                    "under allocation pressure"),
    "cow_copies": ("counter", "Copy-on-write page duplications for fully "
                              "matched prompts"),
    "prefill_tokens_computed": ("counter", "Prompt tokens whose K/V was "
                                           "computed by prefill"),
    "prefill_tokens_cached": ("counter", "Prompt tokens served from the "
                                         "prefix cache (prefill skipped)"),
    "spec_steps": ("counter", "Speculative draft-verify-accept rounds"),
    "spec_drafted_tokens": ("counter", "Tokens proposed by the n-gram "
                                       "drafter"),
    "spec_accepted_tokens": ("counter", "Drafted tokens the verify step "
                                        "accepted"),
    "spec_rejected_tokens": ("counter", "Drafted tokens the verify step "
                                        "rejected (pos rolled back)"),
    "prefill_chunks": ("counter", "Prompt chunks streamed through the "
                                  "mixed prefill/decode step"),
    "mixed_steps": ("counter", "Unified mixed prefill/decode launches"),
    "decode_stall_steps": ("counter", "Whole-prompt prefills dispatched "
                                      "while decode slots sat waiting "
                                      "(0 with chunked prefill on)"),
    "requests_failed": ("counter", "Requests terminated FAILED (fault, "
                                   "NaN guard, unsatisfiable allocation)"),
    "requests_rejected": ("counter", "Requests REJECTED at admission "
                                     "(backpressure or invalid params)"),
    "requests_cancelled": ("counter", "Requests CANCELLED by the caller"),
    "requests_expired": ("counter", "Requests EXPIRED past deadline_s"),
    "degrade_evict": ("counter", "Overload ladder rung 1: proactive "
                                 "prefix-cache leaf evictions"),
    "degrade_spec_off": ("counter", "Overload ladder rung 2: speculation "
                                    "suspended for a step"),
    "degrade_budget_shrink": ("counter", "Overload ladder rung 3: mixed-"
                                         "step prefill rows shrunk to the "
                                         "1-token floor"),
    "degrade_preempt": ("counter", "Overload ladder rung 4: youngest slot "
                                   "preempted under pool pressure"),
    "nan_guard_trips": ("counter", "In-graph NaN/inf logit guard "
                                   "quarantines"),
    "kernel_error_retries": ("counter", "Kernel-dispatch faults retried "
                                        "with state untouched"),
    "tier_demotions": ("counter", "Evicted prefix-cache blocks shipped "
                                  "D2H into the host KV tier"),
    "tier_readmits": ("counter", "Tier blocks restored H2D into the pool "
                                 "(prefill compute skipped)"),
    "tier_hits": ("counter", "Admissions whose prefix match extended "
                             "through the host tier"),
    "tier_evictions": ("counter", "Tier entries LRU-dropped under the "
                                  "byte budget (mirrors the possibly "
                                  "fleet-shared tier's global counter)"),
    "tier_bytes": ("gauge", "Host KV tier bytes resident (mirrors the "
                            "possibly fleet-shared tier's global gauge)"),
    "journal_incremental_updates": ("counter",
                                    "Dirty-rid journal entries rebuilt "
                                    "incrementally (O(changed) per step, "
                                    "docs/async_runtime.md)"),
    "journal_full_rebuilds": ("counter",
                              "Full snapshot() journal rebuilds — steady-"
                              "state async serving keeps this at adopt/"
                              "restore boundaries only"),
    "host_overlap_steps": ("counter",
                           "Steps whose token-independent host work "
                           "overlapped the in-flight device step (async "
                           "host runtime)"),
}

#: fleet router ``stats`` keys -> (metric kind, help); same contract.
FLEET_STAT_SCHEMA = {
    "routed_affinity": ("counter", "Requests routed by longest cached "
                                   "prefix chain"),
    "routed_spill": ("counter", "Requests routed least-loaded (no cached "
                                "chain matched)"),
    "failovers": ("counter", "Replica deaths whose journal was replayed "
                             "onto survivors"),
    "hedges": ("counter", "Stalled-replica requests hedge-dispatched onto "
                          "survivors"),
    "replayed_tokens": ("counter", "Journaled tokens teacher-forced onto "
                                   "survivors (replay + hedge)"),
    "fleet_rejected": ("counter", "Fleet-level rejections (backpressure, "
                                  "invalid request, fleet lost)"),
    "journal_incremental_updates": ("counter",
                                    "Incremental journal() pulls consumed "
                                    "from replicas (failover/hedge "
                                    "boundaries, docs/async_runtime.md)"),
    "journal_full_rebuilds": ("counter",
                              "Full replica snapshot() rebuilds taken by "
                              "the router (per step/dispatch with "
                              "PADDLE_TPU_ASYNC_HOST=0; zero steady-state "
                              "async)"),
    "host_overlap_steps": ("counter",
                           "Fleet steps driven with snapshot refreshes "
                           "deferred to failover boundaries (async host "
                           "runtime)"),
}


class StatsView(MutableMapping):
    """Dict-compatible facade over registry counters/gauges: every read and
    write an existing test or bench makes against ``engine.stats`` /
    ``fleet.stats`` keeps working (``stats[k] += 1``, ``stats[k] = 0``,
    ``stats.update(...)``, ``dict(stats)``), while the same numbers appear
    labelled in ``registry.expose()``.  Keys outside the schema register on
    the fly as counters (dict compatibility must never raise), but the
    schema is the documented surface."""

    def __init__(self, registry: MetricsRegistry, schema: dict,
                 labels: dict | None = None,
                 prefix: str = "paddle_tpu_serving"):
        self._registry = registry
        self._prefix = prefix
        self._labels = dict(labels or {})
        self._children: dict[str, _Value] = {}
        self._order: list[str] = []
        for key, (kind, help) in schema.items():
            fam = registry._register(kind, f"{prefix}_{key}", help)
            self._children[key] = fam.labels(**self._labels)
            self._order.append(key)

    def _child(self, key: str) -> _Value:
        child = self._children.get(key)
        if child is None:
            fam = self._registry._register(
                "counter", f"{self._prefix}_{key}",
                f"dynamically added stat {key!r} (not in the static schema)")
            child = self._children[key] = fam.labels(**self._labels)
            self._order.append(key)
        return child

    def __getitem__(self, key):
        child = self._children.get(key)
        if child is None:
            raise KeyError(key)
        return child.value

    def __setitem__(self, key, value):
        self._child(key).set(value)

    def __delitem__(self, key):
        raise TypeError("stats keys are fixed; set to 0 instead of deleting")

    def __iter__(self):
        return iter(self._order)

    def __len__(self):
        return len(self._order)

    def __repr__(self):
        return f"StatsView({dict(self)!r})"


# --------------------------------------------------- lifecycle tracing

class RequestTracer:
    """Per-request lifecycle spans into the profiler's chrome-trace host
    buffer: pid = replica index, tid = request id, so a run exported via
    ``Profiler().export(path)`` renders as ONE timeline with one process
    lane per replica and one thread lane per request.
    Cross-replica links (failover replay, hedged dispatch) are chrome flow
    events (``ph s/f``) keyed by the request's trace id.

    Every emit is one bounded host-buffer append (the profiler cap drops
    and counts overflow) — O(1), post-step, zero device sync."""

    def __init__(self, enabled: bool = True, pid: int = 0,
                 process_name: str | None = None):
        self.enabled = bool(enabled)
        self.pid = int(pid)
        self.counts: dict[str, int] = {}
        self._process_name = process_name
        self._meta_gen = None       # buffer generation the metadata is in
        if self.enabled and process_name:
            self._emit_process_name()

    def _emit_process_name(self):
        from .. import profiler as _prof

        self._meta_gen = _prof.host_events_generation()
        _prof.add_trace_event({"name": "process_name", "ph": "M",
                               "pid": self.pid,
                               "args": {"name": self._process_name}})

    def _emit(self, ev: dict, name: str):
        from .. import profiler as _prof

        if (self._process_name
                and self._meta_gen != _prof.host_events_generation()):
            # export()/clear drained the buffer, taking the lane-name
            # metadata with it: a long-lived engine that exports
            # periodically must keep its replica lanes labelled in every
            # subsequent trace, not just the first
            self._emit_process_name()
        if _prof.add_trace_event(ev):
            self.counts[name] = self.counts.get(name, 0) + 1

    def span(self, tid: int, name: str, t0_s: float, t1_s: float,
             args: dict | None = None):
        """Complete span [t0_s, t1_s] (perf_counter seconds) on this
        tracer's replica lane, thread lane ``tid`` (the request id)."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "X", "cat": "request",
                    "ts": t0_s * 1e6,
                    "dur": max(t1_s - t0_s, 0.0) * 1e6,
                    "pid": self.pid, "tid": int(tid),
                    **({"args": args} if args else {})}, name)

    def instant(self, tid: int, name: str, t_s: float,
                args: dict | None = None):
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "i", "s": "t", "cat": "request",
                    "ts": t_s * 1e6, "pid": self.pid, "tid": int(tid),
                    **({"args": args} if args else {})}, name)

    def flow_out(self, tid: int, name: str, t_s: float, flow_id: str):
        """Link origin (e.g. the dead replica's last journal state): pairs
        with a :meth:`flow_in` of the same ``flow_id`` on another replica's
        tracer — chrome draws the arrow across process lanes."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "s", "cat": "link", "id": flow_id,
                    "ts": t_s * 1e6, "pid": self.pid, "tid": int(tid)},
                   name)

    def flow_in(self, tid: int, name: str, t_s: float, flow_id: str):
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "f", "bp": "e", "cat": "link",
                    "id": flow_id, "ts": t_s * 1e6, "pid": self.pid,
                    "tid": int(tid)}, name)


# ------------------------------------------------------- SLO accounting

class _LiveSLO:
    __slots__ = ("submit_s", "admit_s", "first_tok_s", "last_tok_s",
                 "max_gap_s", "tokens")

    def __init__(self, submit_s: float):
        self.submit_s = submit_s
        self.admit_s = None
        self.first_tok_s = None
        self.last_tok_s = None
        self.max_gap_s = None
        self.tokens = 0


class SLOTracker:
    """Streaming per-request TTFT / TBT / queue-wait accounting, O(1) per
    token-banking event: the tracker keeps only (first ts, last ts, max
    gap, token count) per live request and a bounded deque of completed
    records — no per-token timestamp lists.

    TBT semantics match what a caller observes: a *banking event* (one
    host fetch delivering >= 1 tokens to a request) is one arrival, and
    gaps are measured between consecutive arrivals — exactly how the fleet
    bench's hand-rolled poll loop measured them before this tracker made
    the figure first-class.  :meth:`goodput_at` is the headline:
    tokens of FINISHED requests that met BOTH latency bounds."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 labels: dict | None = None,
                 prefix: str = "paddle_tpu_serving",
                 capacity: int = 65536):
        self._live: dict[int, _LiveSLO] = {}
        self.records: deque = deque(maxlen=capacity)
        self._h_ttft = self._h_tbt = self._h_qwait = None
        if registry is not None:
            lab = dict(labels or {})
            self._h_ttft = registry.histogram(
                f"{prefix}_ttft_seconds",
                "Submit -> first generated token (wall seconds)"
            ).labels(**lab)
            self._h_tbt = registry.histogram(
                f"{prefix}_tbt_seconds",
                "Gap between consecutive token-banking events per request "
                "(wall seconds)").labels(**lab)
            self._h_qwait = registry.histogram(
                f"{prefix}_queue_wait_seconds",
                "Submit -> admission onto a slot (wall seconds)"
            ).labels(**lab)

    def begin(self, rid: int, submit_s: float):
        self._live[rid] = _LiveSLO(submit_s)

    def admitted(self, rid: int, now_s: float):
        rec = self._live.get(rid)
        if rec is None:
            rec = self._live[rid] = _LiveSLO(now_s)
        if rec.admit_s is None:
            rec.admit_s = now_s
            if self._h_qwait is not None:
                self._h_qwait.observe(now_s - rec.submit_s)

    def tokens(self, rid: int, n: int, now_s: float):
        """Bank one arrival of ``n`` tokens at ``now_s``."""
        if n <= 0:
            return
        rec = self._live.get(rid)
        if rec is None:
            return
        if rec.first_tok_s is None:
            rec.first_tok_s = now_s
            if self._h_ttft is not None:
                self._h_ttft.observe(now_s - rec.submit_s)
        else:
            gap = now_s - rec.last_tok_s
            if rec.max_gap_s is None or gap > rec.max_gap_s:
                rec.max_gap_s = gap
            if self._h_tbt is not None:
                self._h_tbt.observe(gap)
        rec.last_tok_s = now_s
        rec.tokens += n

    def finish(self, rid: int, status: str, now_s: float):
        rec = self._live.pop(rid, None)
        if rec is None:
            return
        self.records.append({
            "rid": rid, "status": status,
            "submit_s": rec.submit_s, "admit_s": rec.admit_s,
            "finish_s": now_s,
            "ttft_s": (None if rec.first_tok_s is None
                       else rec.first_tok_s - rec.submit_s),
            "max_gap_s": rec.max_gap_s,
            "tokens": rec.tokens,
        })

    def goodput_at(self, ttft_slo_s: float, tbt_slo_s: float) -> dict:
        """Goodput AT the SLO over completed records: requests that
        FINISHED, produced a first token within ``ttft_slo_s`` of submit,
        and never gapped longer than ``tbt_slo_s`` between arrivals.
        Returns ``{"requests", "tokens", "rids"}`` — divide tokens by the
        serve's wall clock for the bench headline."""
        rids, toks = [], 0
        for rec in self.records:
            if rec["status"] != "FINISHED" or rec["ttft_s"] is None:
                continue
            if rec["ttft_s"] > ttft_slo_s:
                continue
            if rec["max_gap_s"] is not None and rec["max_gap_s"] > tbt_slo_s:
                continue
            rids.append(rec["rid"])
            toks += rec["tokens"]
        return {"requests": len(rids), "tokens": toks,
                "rids": tuple(sorted(rids))}


# ------------------------------------------------------ flight recorder

class FlightRecorder:
    """Bounded ring buffer of recent engine/fleet events, dumped alongside
    a metrics snapshot when something goes wrong (request FAILED,
    ``EngineAuditError``, replica DEAD) so chaos-test triage reads the
    last seconds of engine history instead of requiring a rerun.

    ``record`` is one deque append (O(1), maxlen drops the oldest and
    ticks ``dropped``).  ``dump`` snapshots the ring into ``self.dumps``
    (itself bounded) and returns the dict; callers may also JSON-serialize
    it (:meth:`dump_json`)."""

    def __init__(self, capacity: int = 256, registry=None,
                 name: str = "engine", max_dumps: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._registry = registry
        self._seq = 0
        self.dropped = 0
        self.dumps: deque = deque(maxlen=max_dumps)

    def record(self, kind: str, /, **detail):
        self._seq += 1
        if len(self._ring) == self.capacity:
            self.dropped += 1           # deque evicts the oldest silently
        self._ring.append({"seq": self._seq, "ts": time.perf_counter(),
                           "kind": kind, **detail})

    def __len__(self):
        return len(self._ring)

    def events(self) -> list[dict]:
        return list(self._ring)

    def dump(self, reason: str, extra: dict | None = None) -> dict:
        d = {
            "recorder": self.name,
            "reason": reason,
            "ts": time.perf_counter(),
            "events_recorded": self._seq,
            "events_dropped": self.dropped,
            "events": self.events(),
            "metrics": (self._registry.expose()
                        if self._registry is not None else None),
        }
        if extra:
            d.update(extra)
        self.dumps.append(d)
        return d

    def dump_json(self, reason: str, extra: dict | None = None) -> str:
        return json.dumps(self.dump(reason, extra), default=repr)
