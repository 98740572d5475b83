"""Validated parsing of the serving engine's ``PADDLE_TPU_*`` switches
(counterpart of ``paddle_tpu/utils/envflags.py``, the two parsers the port's
engine reads).

A typo in an operator's kill switch must never flip it silently: every
parse here warns once per distinct value, naming the offending token and,
where one is close, the valid spelling, and then keeps the default (a
boolean switch) or disables the whole plan (a fault plan).

The boolean switches the engine reads, each '0' or '1':

* ``PADDLE_TPU_PREFIX_CACHE`` (default on): ``0`` turns the prefix cache
  off even when the engine was built with ``enable_prefix_caching=True``;
* ``PADDLE_TPU_ENGINE_AUDIT`` (default off): the per-step invariant
  auditor of the engine and the fleet router
  (``analysis/engine_audit.py``);
* ``PADDLE_TPU_SPECULATE`` (default on): n-gram speculation;
* ``PADDLE_TPU_CHUNKED_PREFILL`` (default on): chunked prefill;
* ``PADDLE_TPU_GRACEFUL`` (default on): the fault-tolerance ladder
  (per-request failure isolation, the overload ladder, the NaN/inf logit
  guard, REJECTED instead of a raise in ``serve``); ``0`` gives the engine
  that raises;
* ``PADDLE_TPU_METRICS`` (default on): the metrics registry, request
  tracing and SLO accounting (``inference/observability.py``); ``0``
  restores the plain stats dict;
* ``PADDLE_TPU_FLIGHT_RECORDER`` (default on): the flight recorder's ring
  and its dumps;
* ``PADDLE_TPU_HOST_KV_TIER`` (default on): the host-RAM spill tier
  behind the prefix cache (``inference/kv_tier.py``); ``0`` forces it off
  even when the engine was built with ``enable_host_kv_tier=True``,
  restoring the pre-tier engine exactly: eviction frees pages again and
  admission stops at the device match.  ``PADDLE_TPU_PREFIX_CACHE=0``
  neutralizes the tier too (with no content address there is nothing to
  demote or match through);
* ``PADDLE_TPU_ASYNC_HOST`` (default on): the async host runtime: the
  engine keeps its journal incrementally (O(changed requests) a step
  instead of a full ``snapshot()``) and flushes it between a step's last
  launch and its one host fetch, while the card runs the queued kernels.
  Token streams are identical either way; ``0`` restores the serial
  fetch-then-bookkeep loop exactly.

The integer knob ``PADDLE_TPU_HOST_TIER_MIB`` is the host tier's byte
budget in MiB (default 256, minimum 1), the ceiling its own LRU evicts
against; a non-integer or sub-minimum value warns once and keeps the
default, so a typo can neither zero nor unbound the tier.

``PADDLE_TPU_FAULT_INJECT`` is the fault plan (``inference/faults.py``).
"""

from __future__ import annotations

import difflib
import os
import warnings

__all__ = ["env_bool", "env_int", "env_fault_spec", "BOOL_FLAGS"]

#: the '0'/'1' switches the engine reads -> their defaults (each read
#: site passes its default explicitly; a test holds the two together)
BOOL_FLAGS = {
    "PADDLE_TPU_PREFIX_CACHE": True,
    "PADDLE_TPU_ENGINE_AUDIT": False,
    "PADDLE_TPU_SPECULATE": True,
    "PADDLE_TPU_CHUNKED_PREFILL": True,
    "PADDLE_TPU_GRACEFUL": True,
    "PADDLE_TPU_METRICS": True,
    "PADDLE_TPU_FLIGHT_RECORDER": True,
    "PADDLE_TPU_HOST_KV_TIER": True,
    "PADDLE_TPU_ASYNC_HOST": True,
}

_warned: set[tuple[str, str]] = set()


def _warn_once(name: str, raw: str, msg: str) -> None:
    if (name, raw) not in _warned:
        _warned.add((name, raw))
        warnings.warn(msg)


def env_bool(name: str, default: bool) -> bool:
    """Boolean switch: '' -> default, '0' -> False, '1' -> True; any other
    value warns once and keeps the default."""
    raw = os.environ.get(name, "")
    if raw in ("", "0", "1"):
        return default if raw == "" else raw == "1"
    _warn_once(name, raw, f"{name}={raw!r} is not '0' or '1'; using the "
                          f"default ({'1' if default else '0'})")
    return default


def env_int(name: str, default: int, minimum: int | None = None) -> int:
    """Integer knob: '' -> default; a non-integer value, or one below
    ``minimum``, warns once and keeps the default."""
    raw = os.environ.get(name, "")
    if raw == "":
        return default
    try:
        value = int(raw)
    except ValueError:
        _warn_once(name, raw, f"{name}={raw!r} is not an integer; using the "
                              f"default ({default})")
        return default
    if minimum is not None and value < minimum:
        _warn_once(name, raw, f"{name}={raw!r} is below the minimum "
                              f"({minimum}); using the default ({default})")
        return default
    return value


def env_fault_spec(name: str, known_kinds, known_keys,
                   fleet_only_kinds=frozenset(),
                   fleet_only_keys=frozenset()) -> list[dict]:
    """Parse a fault plan ``kind@key=val,key=val;kind@...`` (for example
    ``alloc_fail@step=7;nan_logits@slot=2,step=11``) into one dict per
    clause, ``{"kind": ..., <int-valued keys>}`` (``p`` parses as a float).

    An unknown kind or key, or a malformed clause, warns once (with a
    did-you-mean) and returns []: injection off, the engine serves
    normally.  Accepting part of a plan would leave a chaos run's evidence
    unreadable.  ``fleet_only_kinds`` / ``fleet_only_keys`` are the
    replica-scoped vocabulary: with no fleet running, a clause that uses
    them is refused the same way, with a message that names the fleet."""
    raw = os.environ.get(name, "")
    if not raw:
        return []

    def reject(msg: str) -> list[dict]:
        _warn_once(name, raw, f"{name}={raw!r}: {msg}; fault injection "
                              f"DISABLED (the engine serves normally)")
        return []

    def hint(token, vocab):
        close = difflib.get_close_matches(token, set(vocab), n=1, cutoff=0.5)
        return f" (did you mean {close[0]!r}?)" if close else ""

    out: list[dict] = []
    for clause in raw.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        kind, sep, tail = clause.partition("@")
        kind = kind.strip()
        if kind in fleet_only_kinds:
            return reject(f"fault kind {kind!r} is replica-scoped and "
                          f"needs a running FleetRouter "
                          f"(inference/fleet.py) to poll it; no fleet is "
                          f"running, so the clause could never fire")
        if kind not in known_kinds:
            return reject(f"unknown fault kind {kind!r}"
                          f"{hint(kind, set(known_kinds) | fleet_only_kinds)}"
                          f"; known: {sorted(known_kinds)}")
        kv: dict = {"kind": kind}
        for item in tail.split(",") if sep else []:
            item = item.strip()
            if not item:
                continue
            k, eq, v = item.partition("=")
            k = k.strip()
            if eq and k in fleet_only_keys:
                return reject(f"clause key {k!r} in {clause!r} is "
                              f"replica-scoped and needs a running "
                              f"FleetRouter (inference/fleet.py); no fleet "
                              f"is running, so the scope could never match")
            if not eq or k not in known_keys:
                return reject(f"bad clause key {k!r}"
                              f"{hint(k, set(known_keys) | fleet_only_keys)}"
                              f" in {clause!r}; known: {sorted(known_keys)}")
            try:
                kv[k] = float(v) if k == "p" else int(v)
            except ValueError:
                return reject(f"non-numeric value {v.strip()!r} for key "
                              f"{k!r} in {clause!r}")
        out.append(kv)
    return out
