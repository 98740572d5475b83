"""The port's incremental journal and async host runtime on the CPU, held
to ``tests/test_async_runtime.py`` and to the JAX engine.

Same f32 tiny Llama, the JAX parameter tree bridged through
``paddle_tpu_torch.utils.convert``, the same requests (made with numpy from
a seed), every serving feature on (prefix cache, chunked prefill,
speculation, graceful mode); the JAX engine through its plain references
(``PADDLE_TPU_DISABLE_PALLAS=paged_attention``), run once in a module
fixture:

- ``PADDLE_TPU_ASYNC_HOST`` on and off: the same tokens (greedy and
  seeded) and page order; on, one flush a launched step, off, none;
- ``journal()`` equals ``snapshot()`` after every step of a serve
  (``deadline_remaining_s`` aside: each side computes it when read);
- the port's ``journal()`` equals the JAX engine's after every step of
  the same serve, and ``journal_incremental_updates``,
  ``journal_full_rebuilds`` and ``host_overlap_steps`` are the JAX
  engine's;
- the flag is registered and a typo warns once.

The fleet's cases (its failover replaying the journal, the router's
audit) are in ``tests/test_torch_fleet.py``.
"""

import dataclasses
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.inference.serving import Request
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils import envflags
from paddle_tpu_torch.utils.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

_KW = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, inter=64)
#: every serving feature on
FULL = dict(max_batch=2, max_seq=64, chunk=1, block_size=8, num_blocks=16,
            enable_prefix_caching=True, enable_speculation=True,
            num_draft_tokens=3, enable_chunked_prefill=True, prefill_chunk=8)
JOURNAL_STATS = ("journal_incremental_updates", "journal_full_rebuilds",
                 "host_overlap_steps")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(**_KW),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(**_KW),
                               dtype=torch.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _mixed_batch(cls, seed, n=4, prompt_len=11, new=6):
    """Half greedy, half seeded top-p, prompts extending one self-similar
    base (prefix-cache hits and n-gram drafts); rid 3 has a deadline."""
    rs = np.random.RandomState(seed)
    base = np.arange(8, dtype=np.int32)
    reqs = []
    for i in range(n):
        p = np.concatenate([np.tile(base, 3)[:prompt_len],
                            rs.randint(0, 128, (i + 1,)).astype(np.int32)])
        kw = dict(temperature=0.8, top_p=0.9, seed=7 + i) if i % 2 else {}
        reqs.append(cls(rid=i, prompt_ids=p, max_new_tokens=new,
                        deadline_s=600.0 if i == 3 else None, **kw))
    return reqs


def _norm(d):
    """A journal or snapshot with ``deadline_remaining_s`` blanked."""
    return {**d, **{k: [dict(e, deadline_remaining_s=None) for e in d[k]]
                    for k in ("running", "queued")}}


def _stepwise(eng, reqs, each=None):
    """Queue ``reqs`` and step ``eng`` to the end, calling ``each(eng)``
    before the first step and after every step."""
    for r in reqs:
        eng.add_request(r)
    if each is not None:
        each(eng)
    while eng.step() or eng._queue:
        if each is not None:
            each(eng)
    if each is not None:
        each(eng)


@pytest.fixture(scope="module")
def jax_run(models):
    """The JAX engine stepped through ``_mixed_batch(2)``: its journal
    after every step, and its journal statistics."""
    jcfg, jparams = models[:2]
    mp = pytest.MonkeyPatch()
    mp.setenv("PADDLE_TPU_DISABLE_PALLAS", "paged_attention")
    mp.setenv("PADDLE_TPU_ASYNC_HOST", "1")
    eng = JEngine(jcfg, jparams, paged=True, **FULL)
    mp.undo()
    journals = []
    reqs = _mixed_batch(JRequest, 2)
    _stepwise(eng, reqs, lambda e: journals.append(_norm(e.journal())))
    return (journals, [r.output_ids for r in reqs],
            {k: eng.stats[k] for k in JOURNAL_STATS})


def _engine(monkeypatch, models, async_on):
    monkeypatch.setenv("PADDLE_TPU_ASYNC_HOST", "1" if async_on else "0")
    eng = ContinuousBatchingEngine(models[2], models[3], paged=True,
                                   device="cpu",
                                   **FULL)
    monkeypatch.delenv("PADDLE_TPU_ASYNC_HOST")
    assert eng._async_host is async_on
    return eng


def test_async_on_off_token_identity_full_features(monkeypatch, models):
    """On and off: the same greedy and seeded streams and the same page
    order; on, the journal is flushed once in every launched step (chunk
    1: one a decode step), off, never."""
    runs = {}
    for on in (True, False):
        eng = _engine(monkeypatch, models, on)
        reqs = _mixed_batch(Request, 0)
        out = eng.serve(reqs)
        assert all(r.status == "FINISHED" for r in reqs)
        runs[on] = (out, eng)
    (out_on, eng), (out_off, eng_off) = runs[True], runs[False]
    assert out_on == out_off
    assert eng._pcache.resident_pages() == eng_off._pcache.resident_pages()
    assert eng._free == eng_off._free
    st, st_off = eng.stats, eng_off.stats
    assert st["host_overlap_steps"] == st["decode_steps"] > 0
    assert st["journal_incremental_updates"] > 0
    assert st["journal_full_rebuilds"] == 0      # nobody snapshotted
    assert eng._h_jupdate.count > 0
    assert st_off["host_overlap_steps"] == 0
    assert st_off["journal_incremental_updates"] == 0
    assert eng_off._h_jupdate.count == 0
    kinds = {e["kind"] for e in eng._flight.events()}
    assert "journal_flush" in kinds


@pytest.mark.parametrize("async_on", [True, False], ids=["on", "off"])
def test_journal_equals_snapshot_mid_serve(monkeypatch, models, async_on):
    """At every state of a serve (all queued, seating, mid-chunk prefill,
    tokens banked, drained) the journal and a fresh snapshot agree; each
    snapshot counts a full rebuild."""
    eng = _engine(monkeypatch, models, async_on)
    calls = []

    def check(e):
        j = e.journal()
        assert _norm(j) == _norm(e.snapshot())
        calls.append(1)
        for entry in j["running"] + j["queued"]:
            if entry["deadline_s"] is not None:
                assert 0.0 < entry["deadline_remaining_s"] <= 600.0

    _stepwise(eng, _mixed_batch(Request, 2), check)
    assert eng.stats["journal_full_rebuilds"] == len(calls)
    assert eng.journal()["running"] == eng.journal()["queued"] == []


def test_journal_matches_jax(monkeypatch, models, jax_run):
    """The same serve stepped through both packages: the port's journal
    after every step is the JAX engine's, and so are the tokens and the
    journal statistics."""
    journals = []
    eng = _engine(monkeypatch, models, True)
    reqs = _mixed_batch(Request, 2)
    _stepwise(eng, reqs, lambda e: journals.append(_norm(e.journal())))
    jjournals, jtokens, jstats = jax_run
    assert [r.output_ids for r in reqs] == jtokens
    assert len(journals) == len(jjournals)
    for i, (a, b) in enumerate(zip(journals, jjournals)):
        assert a == b, f"journal after step {i}"
    assert {k: eng.stats[k] for k in JOURNAL_STATS} == jstats
    assert jstats["journal_incremental_updates"] > 0


def test_flag_registered_and_typo_warns_once(monkeypatch):
    assert envflags.BOOL_FLAGS["PADDLE_TPU_ASYNC_HOST"] is True
    assert "PADDLE_TPU_ASYNC_HOST" in envflags.__doc__
    monkeypatch.setenv("PADDLE_TPU_ASYNC_HOST", "off")
    envflags._warned.clear()
    with pytest.warns(UserWarning, match="PADDLE_TPU_ASYNC_HOST"):
        assert envflags.env_bool("PADDLE_TPU_ASYNC_HOST", True) is True
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert envflags.env_bool("PADDLE_TPU_ASYNC_HOST", True) is True
