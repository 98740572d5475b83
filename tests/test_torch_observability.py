"""The port's serving observability on the CPU: the engine-side cases of
``tests/test_observability.py`` held to ``paddle_tpu_torch``, and one
against the JAX engine.

- ``MetricsRegistry``: exposition format, log2 buckets, re-registration;
  ``StatsView`` as a dict; the schemas are the reference's, key for key
  and help for help; the engine's ``stats`` keys are the schema's, the
  host-tier keys staying 0 without a tier and the journal flushed once a
  step;
- the switches: ``PADDLE_TPU_METRICS=0`` restores the plain dict,
  ``PADDLE_TPU_FLIGHT_RECORDER=0`` drops the recorder, a typo warns;
- token identity with observability on and off (prefix cache, chunked
  prefill, speculation and graceful mode all on; greedy and seeded);
- request spans into the port's host trace buffer, drained by export;
  stable trace ids; the buffer cap drops and counts; process names
  re-emitted after a drain;
- ``SLOTracker`` and the engine's SLO, step and host-gap histograms;
- ``FlightRecorder``'s ring bounds and a dump on a request a
  ``FaultPlan`` fails;
- against the JAX engine on one stream (prefix cache, chunked prefill,
  speculation, graceful off; the JAX engine on its plain references):
  every statistic counter by counter (the wall-time gauge aside), the SLO
  records' statuses and token counts, and the number of observations of
  each histogram.
"""

import dataclasses
import json
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.inference import observability as jobs
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.inference.observability import (ENGINE_STAT_SCHEMA,
                                                      FLEET_STAT_SCHEMA,
                                                      FlightRecorder,
                                                      MetricsRegistry,
                                                      SLOTracker, StatsView)
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.inference.serving import Request
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.utils.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

_KW = dict(vocab=128, hidden=64, layers=2, heads=8, kv_heads=4, inter=128)
_CFG = dataclasses.replace(llama.LlamaConfig.tiny(**_KW), dtype=torch.float32)
#: the host KV tier's statistics: 0 on an engine without a tier
TIER_KEYS = ("tier_bytes", "tier_demotions", "tier_evictions", "tier_hits",
             "tier_readmits")
FEATURES = dict(num_blocks=24, enable_prefix_caching=True,
                enable_speculation=True, num_draft_tokens=3,
                enable_chunked_prefill=True, prefill_chunk=8)


@pytest.fixture(scope="module")
def params():
    return llama.init_params(_CFG, seed=0, device="cpu")


def _engine(params, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("block_size", 8)
    return ContinuousBatchingEngine(_CFG, params, paged=True,
                                    device="cpu", **kw)


def _requests(n=3, new=5, seed=0, cls=Request):
    rs = np.random.RandomState(seed)
    return [cls(rid=i, prompt_ids=rs.randint(0, 128, (10 + i,)).astype(
        np.int32), max_new_tokens=new) for i in range(n)]


def _shared_prefix_requests(cls=Request):
    """Four requests behind one 16-token prefix, greedy and seeded."""
    rs = np.random.RandomState(7)
    shared = np.arange(16, dtype=np.int32)
    return [cls(rid=i, prompt_ids=np.concatenate(
        [shared, rs.randint(0, 128, (6,)).astype(np.int32)]),
        max_new_tokens=8, temperature=0.7 if i % 2 else 0.0, seed=11 + i)
        for i in range(4)]


@pytest.fixture(autouse=True)
def _clean_host_events():
    profiler.clear_host_events()
    yield
    profiler.set_host_event_capacity(65536)
    profiler.clear_host_events()


# ---------------- MetricsRegistry ----------------

def test_counter_gauge_exposition_format():
    reg = MetricsRegistry()
    c = reg.counter("t_requests", "requests served").labels(replica="0")
    c.inc()
    c.inc(2)
    g = reg.gauge("t_time_s", "wall seconds").labels()
    g.set(1.5)
    text = reg.expose()
    assert "# HELP t_requests requests served" in text
    assert "# TYPE t_requests counter" in text
    assert 't_requests{replica="0"} 3' in text
    assert "# TYPE t_time_s gauge" in text
    assert "t_time_s 1.5" in text


def test_histogram_log2_buckets_and_cumulative_counts():
    reg = MetricsRegistry()
    h = reg.histogram("t_lat_seconds", "latency", lo=-2, hi=2).labels()
    for v in (0.1, 0.25, 0.26, 1.0, 3.0, 100.0):
        h.observe(v)
    assert h.count == 6 and h.sum == pytest.approx(104.61)
    pairs = dict(h.buckets(-2))
    assert pairs["0.25"] == 2
    assert pairs["0.5"] == 3
    assert pairs["1"] == 4
    assert pairs["4"] == 5
    assert pairs["+Inf"] == 6
    text = reg.expose()
    assert 't_lat_seconds_bucket{le="+Inf"} 6' in text
    assert "t_lat_seconds_count 6" in text
    h2 = reg.histogram("t_h", "h", lo=-2, hi=2).labels()
    for v in (0.0, -1.0, float("nan")):
        h2.observe(v)
    assert dict(h2.buckets(-2))["0.25"] == 3


def test_registry_reregistration_same_family_and_mismatch_raises():
    reg = MetricsRegistry()
    assert reg.counter("t_x", "help") is reg.counter("t_x", "help")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("t_x", "help")
    with pytest.raises(ValueError, match="help"):
        reg.counter("t_y", "")


def test_stats_view_behaves_like_the_old_dict():
    reg = MetricsRegistry()
    view = StatsView(reg, ENGINE_STAT_SCHEMA, {"replica": "1"})
    view["decode_tokens"] += 3
    view["decode_time_s"] += 0.5
    assert view["decode_tokens"] == 3 and isinstance(view["decode_tokens"],
                                                     int)
    view.update(decode_steps=0, decode_tokens=0, decode_time_s=0.0)
    assert view["decode_tokens"] == 0
    d = dict(view)
    assert set(d) == set(ENGINE_STAT_SCHEMA)
    assert d["decode_time_s"] == 0.0
    view["prefix_hits"] += 2
    assert 'paddle_tpu_serving_prefix_hits{replica="1"} 2' in reg.expose()
    with pytest.raises(TypeError):
        del view["decode_tokens"]
    with pytest.raises(KeyError):
        view["no_such_stat"]
    view["adhoc_counter"] = 7
    assert view["adhoc_counter"] == 7


def test_schemas_are_the_reference_s():
    assert ENGINE_STAT_SCHEMA == jobs.ENGINE_STAT_SCHEMA
    assert list(ENGINE_STAT_SCHEMA) == list(jobs.ENGINE_STAT_SCHEMA)
    assert FLEET_STAT_SCHEMA == jobs.FLEET_STAT_SCHEMA


def test_engine_stats_keys_match_schema_exactly(params):
    eng = _engine(params, **FEATURES)
    assert set(eng.stats) == set(ENGINE_STAT_SCHEMA)
    helps = eng.metrics.describe()
    for key in ENGINE_STAT_SCHEMA:
        assert helps[f"paddle_tpu_serving_{key}"].strip()
    eng.serve(_shared_prefix_requests())
    assert set(eng.stats) == set(ENGINE_STAT_SCHEMA)
    assert eng.stats["decode_tokens"] == 32 and eng.stats["prefix_hits"] > 0
    assert all(eng.stats[k] == 0 for k in TIER_KEYS)
    assert eng.stats["host_overlap_steps"] == eng.stats["decode_steps"]
    assert eng.stats["journal_incremental_updates"] > 0
    assert eng.stats["journal_full_rebuilds"] == 0
    assert eng.prefill_time_s == 0.0      # chunked: no bucketed prefill
    text = eng.metrics.expose()
    for key, (kind, _) in ENGINE_STAT_SCHEMA.items():
        if kind == "counter":
            assert f"paddle_tpu_serving_{key} {eng.stats[key]}\n" in text


# ---------------- switches ----------------

def test_metrics_off_restores_plain_dict(monkeypatch, params):
    monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
    eng = _engine(params)
    assert type(eng.stats) is dict
    assert eng.metrics is None and eng.slo is None
    assert set(eng.stats) == set(ENGINE_STAT_SCHEMA)
    assert eng.stats["decode_time_s"] == 0.0
    eng.serve(_requests(2))
    assert profiler.host_events_len() == 0       # no spans either
    assert eng._flight is not None and len(eng._flight) > 0


def test_flight_recorder_off_and_typo_warns(monkeypatch, params):
    from paddle_tpu_torch.utils import envflags

    monkeypatch.setenv("PADDLE_TPU_FLIGHT_RECORDER", "0")
    eng = _engine(params)
    assert eng._flight is None
    assert eng.serve(_requests(2))[1]
    for flag in ("PADDLE_TPU_METRICS", "PADDLE_TPU_FLIGHT_RECORDER"):
        monkeypatch.setenv(flag, "off")
        envflags._warned.clear()
        with pytest.warns(UserWarning, match=flag):
            assert envflags.env_bool(flag, True) is True


def test_token_identity_with_observability_on_vs_off(monkeypatch, params):
    """Greedy and seeded streams identical with metrics, tracing and the
    flight recorder on and with both switches off, with the prefix cache,
    speculation, chunked prefill and graceful mode all on."""
    outs = {}
    for on in (True, False):
        if on:
            monkeypatch.delenv("PADDLE_TPU_METRICS", raising=False)
            monkeypatch.delenv("PADDLE_TPU_FLIGHT_RECORDER", raising=False)
        else:
            monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
            monkeypatch.setenv("PADDLE_TPU_FLIGHT_RECORDER", "0")
        eng = _engine(params, **FEATURES)
        assert eng._graceful
        outs[on] = eng.serve(_shared_prefix_requests())
        assert eng.stats["spec_steps"] > 0 and eng.stats["mixed_steps"] > 0
        assert eng.stats["prefix_hits"] > 0
    assert outs[True] == outs[False]


# ---------------- lifecycle tracing ----------------

def test_request_spans_emitted_and_export_drains(tmp_path, params):
    eng = _engine(params, enable_chunked_prefill=True, prefill_chunk=4)
    eng.serve(_requests(2, new=4))
    path = tmp_path / "trace.json"
    profiler.Profiler().export(str(path))
    events = json.load(open(path))["traceEvents"]
    names = {e["name"] for e in events}
    assert {"queued", "prefill_chunk", "decode"} <= names
    assert any(e["name"].startswith("terminal:FINISHED") for e in events)
    assert {e["tid"] for e in events if e["name"] == "decode"} == {0, 1}
    assert profiler.host_events_len() == 0
    assert eng._tracer.counts["decode"] == 2
    assert eng._tracer.counts["queued"] == 2
    # the bucketed engine's whole-prompt prefill span
    eng = _engine(params)
    eng.serve(_requests(2, new=2))
    spans = [e for e in _drain(tmp_path) if e["name"] == "prefill"]
    assert sorted(e["tid"] for e in spans) == [0, 1]
    assert all(e["args"]["tokens"] == 9 + e["tid"] for e in spans)


def _drain(tmp_path):
    path = tmp_path / "drain.json"
    profiler.Profiler().export(str(path))
    return json.load(open(path))["traceEvents"]


def test_trace_ids_assigned_and_stable(params):
    eng = _engine(params)
    reqs = _requests(2)
    eng.serve(reqs)
    assert reqs[0].trace_id == "req-0" and reqs[1].trace_id == "req-1"


def test_profiler_buffer_cap_drops_and_counts(tmp_path):
    prev = profiler.set_host_event_capacity(8)
    try:
        for i in range(20):
            profiler.add_trace_event({"name": f"span{i}", "ph": "i",
                                      "ts": i})
        assert profiler.host_events_len() == 8
        assert profiler.host_events_dropped() == 12
        events = _drain(tmp_path)
        assert any(e.get("name") == "host_events_dropped"
                   and e["args"]["dropped"] == 12 for e in events)
        assert profiler.host_events_len() == 0
        assert profiler.host_events_dropped() == 0
        profiler.add_trace_event({"name": "after", "ph": "i", "ts": 0})
        assert profiler.host_events_len() == 1
    finally:
        profiler.set_host_event_capacity(prev)
    with pytest.raises(ValueError, match="capacity"):
        profiler.set_host_event_capacity(0)


def test_process_names_survive_drain_on_export(tmp_path, params):
    eng = _engine(params)
    eng.serve(_requests(1, new=2))
    _drain(tmp_path)
    eng.serve(_requests(1, new=2, seed=1))
    events = _drain(tmp_path)
    assert any(e.get("ph") == "M" and e.get("name") == "process_name"
               and e["args"]["name"] == "engine" for e in events)


# ---------------- SLOTracker ----------------

def test_slo_tracker_streaming_accounting():
    t = SLOTracker()
    t.begin(1, 100.0)
    t.admitted(1, 100.5)
    t.tokens(1, 1, 101.0)
    t.tokens(1, 2, 101.2)
    t.tokens(1, 1, 103.0)
    t.finish(1, "FINISHED", 103.1)
    t.begin(2, 100.0)
    t.tokens(2, 1, 109.0)
    t.finish(2, "FINISHED", 109.1)
    t.begin(3, 100.0)
    t.finish(3, "FAILED", 101.0)
    rec = {r["rid"]: r for r in t.records}
    assert rec[1]["ttft_s"] == pytest.approx(1.0)
    assert rec[1]["max_gap_s"] == pytest.approx(1.8)
    assert rec[1]["tokens"] == 4
    assert rec[3]["ttft_s"] is None
    assert t.goodput_at(ttft_slo_s=5.0, tbt_slo_s=2.0) == {
        "requests": 1, "tokens": 4, "rids": (1,)}
    assert t.goodput_at(5.0, 1.0)["requests"] == 0
    assert t.goodput_at(10.0, 2.0)["tokens"] == 5


def test_engine_slo_histograms_and_records(params):
    eng = _engine(params)
    eng.serve(_requests(3, new=4))
    assert len(eng.slo.records) == 3
    assert all(r["status"] == "FINISHED" and r["tokens"] == 4
               for r in eng.slo.records)
    g = eng.slo.goodput_at(60.0, 60.0)
    assert g["requests"] == 3 and g["tokens"] == 12
    text = eng.metrics.expose()
    assert "paddle_tpu_serving_ttft_seconds_count 3" in text
    assert "paddle_tpu_serving_queue_wait_seconds_count 3" in text
    # one step-time observation a device step, one host gap between two
    steps = eng.stats["decode_steps"]
    assert f"paddle_tpu_serving_step_seconds_count {steps}\n" in text
    assert eng._h_hostgap.count == steps - 1
    assert re.search(r"paddle_tpu_serving_tbt_seconds_count [1-9]", text)


# ---------------- flight recorder ----------------

def test_flight_recorder_ring_bounds_and_drop_counter():
    fr = FlightRecorder(capacity=4)
    for i in range(10):
        fr.record("e", i=i)
    assert len(fr) == 4 and fr.dropped == 6
    assert [e["i"] for e in fr.events()] == [6, 7, 8, 9]
    d = fr.dump("why")
    assert d["events_dropped"] == 6 and len(d["events"]) == 4
    assert fr.dumps[-1] is d
    json.loads(fr.dump_json("again"))
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=0)


def test_flight_dump_on_request_failure(monkeypatch, params):
    monkeypatch.setenv("PADDLE_TPU_FAULT_INJECT", "slot_error@step=3")
    eng = _engine(params)
    reqs = _requests(2, new=6)
    eng.serve(reqs)
    assert sum(r.status == "FAILED" for r in reqs) == 1
    assert len(eng._flight.dumps) == 1
    d = eng._flight.dumps[0]
    victim = next(r for r in reqs if r.status == "FAILED")
    assert d["reason"] == f"request_failed rid={victim.rid}"
    assert "paddle_tpu_serving_requests_failed" in d["metrics"]
    kinds = {e["kind"] for e in d["events"]}
    assert {"admit", "fault", "terminal"} <= kinds
    fault = next(e for e in d["events"] if e["kind"] == "fault")
    assert fault["fault"] == "slot_error" and fault["rid"] == victim.rid


# ---------------- against the JAX engine ----------------

def test_stats_and_slo_match_jax(monkeypatch):
    """One stream through both packages' engines (prefix cache, chunked
    prefill, speculation; graceful off, as the other JAX comparisons run):
    every counter of the schema equal (``decode_time_s`` is wall time),
    the SLO records' statuses and token counts equal, and each histogram
    observed as often."""
    monkeypatch.setenv("PADDLE_TPU_DISABLE_PALLAS", "paged_attention")
    monkeypatch.setenv("PADDLE_TPU_GRACEFUL", "0")
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(**_KW),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    jeng = JEngine(jcfg, jparams, paged=True, max_batch=2, max_seq=64,
                   block_size=8, **FEATURES)
    jout = jeng.serve(_shared_prefix_requests(JRequest))
    teng = _engine(tparams, **FEATURES)
    tout = teng.serve(_shared_prefix_requests())
    assert tout == jout
    skip = {"decode_time_s"}
    assert ({k: teng.stats[k] for k in ENGINE_STAT_SCHEMA if k not in skip}
            == {k: jeng.stats[k] for k in ENGINE_STAT_SCHEMA
                if k not in skip})

    def slo(eng):
        return sorted((r["rid"], r["status"], r["tokens"])
                      for r in eng.slo.records)

    assert slo(teng) == slo(jeng)
    for h in ("_h_ttft", "_h_tbt", "_h_qwait"):
        assert getattr(teng.slo, h).count == getattr(jeng.slo, h).count, h
    assert teng._h_step.count == jeng._h_step.count
    assert teng._h_hostgap.count == jeng._h_hostgap.count
    assert teng._h_jupdate.count == jeng._h_jupdate.count
