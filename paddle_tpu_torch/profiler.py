"""Host trace buffer and span markers (counterpart of the host-event half
of ``paddle_tpu/profiler/__init__.py``).

Ported: the bounded buffer of raw chrome-trace events that the serving
engine's request tracer (``inference/observability.RequestTracer``)
writes into; :class:`RecordEvent`, the span marker the serving engine and
the fleet router put around their transitions (rejection, expiry,
cancellation, failure, the fault ladder's rungs, snapshot and restore,
prefix-cache eviction and copy-on-write, the host tier's moves, failover,
hedging), which writes one ``"X"`` event into that buffer and opens
``torch.profiler.record_function`` for the span, so it shows in a
``torch.profiler`` trace as the reference's shows in a JAX trace; and
:meth:`Profiler.export`, which writes the buffered events as one chrome
trace and drains the buffer.  Not ported: the reference's native (C++)
host tracer, the scheduler states and the device trace; on the card,
device time is read with ``torch.profiler`` or CUDA events instead.

The buffer is bounded: a long-lived engine emits spans forever.  At
capacity a new event is DROPPED and counted rather than evicting an old
one (a trace renders contiguous history better than one with holes);
export drains the buffer and writes the drop count as a metadata event.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["Profiler", "RecordEvent", "add_trace_event",
           "host_events_generation", "host_events_len",
           "host_events_dropped", "set_host_event_capacity",
           "clear_host_events"]

_events_lock = threading.Lock()
_events: list[dict] = []
_MAX_HOST_EVENTS_DEFAULT = 65536
_capacity = _MAX_HOST_EVENTS_DEFAULT
_dropped = 0
# bumped on every drain (export / clear): an emitter holding one-shot
# metadata (the request tracer's process_name lane label) watches it to
# know the metadata left with a drain and must be emitted again
_generation = 0


def host_events_generation() -> int:
    return _generation


def add_trace_event(ev: dict) -> bool:
    """Append one raw chrome-trace event dict to the host buffer, honoring
    the capacity cap.  Returns False when the event was dropped."""
    global _dropped
    with _events_lock:
        if len(_events) >= _capacity:
            _dropped += 1
            return False
        _events.append(ev)
    return True


def host_events_len() -> int:
    with _events_lock:
        return len(_events)


def host_events_dropped() -> int:
    return _dropped


def set_host_event_capacity(n: int) -> int:
    """Set the host buffer's cap (>= 1); returns the previous value."""
    global _capacity
    if int(n) < 1:
        raise ValueError(f"capacity must be >= 1, got {n}")
    prev = _capacity
    _capacity = int(n)
    return prev


def clear_host_events() -> None:
    """Drop the buffered host events and reset the drop counter."""
    global _dropped, _generation
    with _events_lock:
        _events.clear()
    _dropped = 0
    _generation += 1


class RecordEvent:
    """A host span (the reference's ``paddle.profiler.RecordEvent``):
    ``begin`` / ``end``, or a ``with`` block, writes one complete
    (``"ph": "X"``, ``"cat": "host"``) event into the host buffer at its
    end, and holds ``torch.profiler.record_function(name)`` open between
    the two, so the span also shows in a ``torch.profiler`` trace."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._t0 = None
        self._fn = None

    def begin(self):
        from torch.profiler import record_function

        self._t0 = time.perf_counter_ns() / 1000.0
        self._fn = record_function(self.name)
        self._fn.__enter__()

    def end(self):
        if self._t0 is None:
            return
        self._fn.__exit__(None, None, None)
        self._fn = None
        t1 = time.perf_counter_ns() / 1000.0
        add_trace_event({"name": self.name, "ph": "X", "ts": self._t0,
                         "dur": t1 - self._t0, "pid": os.getpid(),
                         "tid": threading.get_ident() % 100000,
                         "cat": "host"})
        self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Profiler:
    """The export end of the host buffer."""

    def export(self, path: str, format: str = "json"):
        """Write the buffered host events as one chrome trace (``{"
        traceEvents": [...], "displayTimeUnit": "ms"}``) and DRAIN them:
        export is the buffer's consumer, so an engine that exports
        periodically never reaches the cap.  Events dropped at the cap are
        counted in a ``host_events_dropped`` metadata event, and the count
        resets."""
        global _dropped, _generation
        if format != "json":
            raise ValueError(f"only the json chrome-trace format is "
                             f"written, got {format!r}")
        with _events_lock:
            events = list(_events)
            _events.clear()
            dropped, _dropped = _dropped, 0
            _generation += 1
        if dropped:
            events.append({"name": "host_events_dropped", "ph": "M",
                           "pid": os.getpid(),
                           "args": {"dropped": dropped}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
