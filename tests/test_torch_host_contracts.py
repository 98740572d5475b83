"""The port's host-contract pass (``paddle_tpu_torch/analysis/
host_contracts.py``) against the reference's (``paddle_tpu/analysis/
host_contracts.py``), and its gate ``python -m paddle_tpu_torch.analysis
--host``.

* Every fixture of the reference's ``tests/test_host_contracts.py`` (the
  sources below are its, verbatim) goes through both passes with the same
  ``(name, source, filename)`` and equal MachineSpecs, each built from its
  own package's class: findings equal as (rule, severity, message,
  where), sections equal.
* Both passes over the port's ``serving.py`` and ``fleet.py`` with the
  port's tables: equal but for the one blocking label (the port names
  ``.tolist``, the reference ``np.asarray``, at the same line).
* torch's host syncs are found at their line and function.
* The port's modules are pinned: 3 windows, 9 journal-overlap races,
  1 blocking call in ``journal_entry``, 25 transition sites, every edge
  covered, all 10 allowlisted, raw equal to the budget's ceiling.
* Determinism and the memo, the depth knob, and the CLI's exit codes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import textwrap

import pytest
from torch_threads import one_torch_thread  # noqa: F401

from paddle_tpu_torch.analysis import Report, Severity, load_allowlist
from paddle_tpu_torch.analysis import __main__ as cli
from paddle_tpu_torch.analysis import host_contracts as hc
from paddle_tpu_torch.analysis.report import load_budgets
from paddle_tpu_torch.utils import envflags

REF_ALLOWLIST = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "paddle_tpu", "analysis", "allowlist.toml")


@pytest.fixture(scope="module")
def ref():
    """The reference pass, imported once for the module."""
    from paddle_tpu.analysis import host_contracts

    return host_contracts


def _modules(src, name="fixture_engine"):
    return [(name, textwrap.dedent(src), f"{name}.py")]


# ---------------------------------------------------------------------------
# the reference test file's fixtures, verbatim
# ---------------------------------------------------------------------------

SRC_RACE = """
    class FixtureEngine:
        def _host_overlap(self):
            self._table = self._rebuild()

        def step(self):
            operands = self._table
            launch = self._launch(operands)
            self._host_overlap()
            return launch
    """

SRC_BLOCKING = """
    import numpy as np

    class FixtureEngine:
        def _host_overlap(self):
            self._sync_tokens()

        def _sync_tokens(self):
            self.last = np.asarray(self._device_tokens)

        def step(self):
            launch = self._launch()
            self._host_overlap()
            return launch
    """

SRC_HEALTH = """
    class FixtureRouter:
        def _health_to(self, r, state):
            prev = self.health[r]
            if prev == state:
                return
            self.health[r] = state

        def _kill(self, r):
            self._health_to(r, "DEAD")

        def _degrade(self, r):
            if self.health[r] == "HEALTHY":
                self._health_to(r, "DEGRADED")

        def _heal(self, r):
            self._health_to(r, "HEALTHY")
    """

SRC_RESURRECT = """
    class FixtureEngine:
        def _admit(self, req):
            if req.status == "PENDING":
                req.status = "RUNNING"

        def _retire(self, req):
            req.status = "FINISHED"

        def retry(self, req):
            if req.status == "FINISHED":
                req.status = "RUNNING"
    """

SRC_MIRROR = """
        class FixtureRouter:
            def _finish(self, f, copy):
                f.status = copy.status
    """

SRC_DYNAMIC = """
        class FixtureEngine:
            def mark(self, req, flag):
                req.status = "RUN" + flag
    """

SRC_CLEAN = """
        class FixtureEngine:
            def _host_overlap(self):
                self.overlap_ticks = self.overlap_ticks + 1

            def step(self):
                launch = self._launch(self.table)
                self._host_overlap()
                return launch
    """

SRC_STALE = """
        class FixtureEngine:
            def _host_overlap(self):
                pass

            def step(self):
                launch = self._launch()
                self._host_overlap()
                return launch
    """


def _health_kw():
    return dict(
        name="fixture_health", field="health", kind="self_index",
        states=("HEALTHY", "DEGRADED", "DEAD"),
        edges=frozenset({("HEALTHY", "DEGRADED"), ("DEGRADED", "HEALTHY"),
                         ("HEALTHY", "DEAD"), ("DEGRADED", "DEAD")}),
        terminal=frozenset({"DEAD"}), initial="HEALTHY",
        default_sources=frozenset(("HEALTHY", "DEGRADED", "DEAD")),
        ladder=("HEALTHY", "DEGRADED", "DEAD"),
        heal_edges=frozenset({("DEGRADED", "HEALTHY")}))


def _request_kw():
    return dict(
        name="fixture_lifecycle", field="status", kind="attr",
        states=("PENDING", "RUNNING", "FINISHED"),
        edges=frozenset({("PENDING", "RUNNING"), ("PENDING", "FINISHED"),
                         ("RUNNING", "FINISHED")}),
        terminal=frozenset({"FINISHED"}), initial="PENDING",
        default_sources=frozenset(("PENDING", "RUNNING")))


_HEALTH = _health_kw()
#: the reference's three bad declared tables (its model-check test)
_BAD_TABLES = {
    "leaky": {**_HEALTH, "edges": _HEALTH["edges"] | {("DEAD", "HEALTHY")}},
    "climby": {**_HEALTH, "heal_edges": frozenset()},
    "island": {**_HEALTH, "states": _HEALTH["states"] + ("LIMBO",)},
}

#: name -> (source, machine kwargs, depth, (rule, count, needles)):
#: each row also checks the reference test's own claim on the port
FIXTURES = {
    "race": (SRC_RACE, (), None,
             ("host_race", 1, ("self._table", "FixtureEngine.step"))),
    "blocking": (SRC_BLOCKING, (), None,
                 ("host_blocking", 1, ("np.asarray", "_sync_tokens"))),
    "health": (SRC_HEALTH, (_health_kw(),), None,
               ("host_transition", 1, ("DEAD->HEALTHY", "_heal"))),
    "resurrect": (SRC_RESURRECT, (_request_kw(),), None,
                  ("host_transition", 1, ("FINISHED->RUNNING", "retry"))),
    "dead_edge": (SRC_HEALTH.replace("self._health_to(r, \"DEGRADED\")",
                                     "pass"), (_health_kw(),), None,
                  ("host_dead_edge", 1, ("HEALTHY->DEGRADED",))),
    "mirror": (SRC_MIRROR, (_request_kw(),), None,
               ("host_transition", 0, ())),
    "dynamic": (SRC_DYNAMIC, (_request_kw(),), None,
                ("host_transition", 1, ("dynamic",))),
    "leaky": ("x = 1", (_BAD_TABLES["leaky"],), None,
              ("host_protocol", 2, ("absorbing", "ladder"))),
    "climby": ("x = 1", (_BAD_TABLES["climby"],), None,
               ("host_protocol", 1, ("ladder",))),
    "island": ("x = 1", (_BAD_TABLES["island"],), None,
               ("host_protocol", 2, ("unreachable",))),
    "depth0": (SRC_BLOCKING, (), 0, ("host_blocking", 0, ())),
    "clean": (SRC_CLEAN, (), None, ("host_race", 0, ())),
}


def _rows(findings):
    return [(f.rule, f.severity, f.message, f.where) for f in findings]


def _as(cls, spec):
    """``spec`` rebuilt from the other package's MachineSpec class."""
    return cls(**{f.name: getattr(spec, f.name)
                  for f in dataclasses.fields(spec)})


def test_fixture_sources_are_the_references():
    import test_host_contracts as t

    assert (SRC_RACE, SRC_BLOCKING, SRC_HEALTH, SRC_RESURRECT) == (
        t.SRC_RACE, t.SRC_BLOCKING, t.SRC_HEALTH, t.SRC_RESURRECT)
    assert _as(hc.MachineSpec, t._health_machine()) == hc.MachineSpec(
        **_health_kw())
    assert _as(hc.MachineSpec, t._request_machine()) == hc.MachineSpec(
        **_request_kw())


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_matches_reference(ref, name):
    src, kws, depth, (rule, count, needles) = FIXTURES[name]
    mods = _modules(src)
    mine = hc.check_host_contracts(
        target="t", modules=mods, machines=tuple(
            hc.MachineSpec(**kw) for kw in kws), depth=depth)
    theirs = ref.check_host_contracts(
        target="t", modules=mods, machines=tuple(
            ref.MachineSpec(**kw) for kw in kws), depth=depth)
    assert _rows(mine[0]) == _rows(theirs[0])
    assert mine[1] == theirs[1]
    findings, sections = mine
    hits = [f for f in findings if f.rule == rule]
    assert len(hits) == count
    assert all(f.severity == Severity.ERROR for f in findings)
    for needle in needles:
        assert any(needle in f.message or needle in f.where for f in hits)
    if name == "mirror":
        sec = [s for s in sections if s["kind"] == "machine"][0]
        assert sec["mirror_sites"] == 1 and sec["sites"] == 0
    if name == "health":
        sec = [s for s in sections if s["kind"] == "machine"][0]
        assert sec["dead_edges"] == []


def _port_inputs():
    return hc._default_modules(), hc._default_machines()


def test_port_modules_match_reference_but_the_label(ref):
    """Over the port's own modules and tables the two passes agree on every
    finding and section; the one difference is the blocking label at
    ``journal_entry``'s conversion: the port names ``.tolist`` (it visits
    the outer call of ``np.asarray(...).ravel().tolist()`` first), the
    reference ``np.asarray``, and the port's sections list both."""
    mods, machines = _port_inputs()
    mine, msec = hc.check_host_contracts(target="host", modules=mods,
                                         machines=machines)
    theirs, tsec = ref.check_host_contracts(
        target="host", modules=mods,
        machines=tuple(_as(ref.MachineSpec, m) for m in machines))
    swap = [(r, s, m.replace(".tolist in journal_entry",
                             "np.asarray in journal_entry"), w)
            for r, s, m, w in _rows(mine)]
    assert swap == _rows(theirs) and _rows(mine) != _rows(theirs)
    for a, b in zip(msec, tsec, strict=True):
        if a["kind"] == "overlap":
            extra = [x for x in a["blocking"] if x not in b["blocking"]]
            assert [x.split(" [")[0] for x in extra] == [
                ".tolist in journal_entry"]
            a = dict(a, blocking=[x for x in a["blocking"]
                                  if x not in extra])
        assert a == b


LABELS_SRC = """
import numpy as np
import torch
import torch.distributed as dist


class Engine:
    def _host_overlap(self):
        self._fetch()

    def _fetch(self):
        a = self.t.cpu()
        b = self.t.item()
        c = self.t.tolist()
        d = self.t.numpy()
        e = self.t.to("cpu")
        f = self.t.to(device="cpu")
        torch.cuda.synchronize()
        self.stream.synchronize()
        dist.all_reduce(self.t)
        torch.distributed.broadcast(self.t, 0)
        dist.all_reduce(self.t, async_op=True)
        g = self.t.to("cuda")
        h = torch.as_tensor(self.host, device="cuda")
        i = np.asarray(self.host)

    def step(self):
        launch = self._launch()
        self._host_overlap()
        return launch
"""


def test_torch_sync_labels_found_at_line_and_function():
    findings, sections = hc.check_host_contracts(
        target="t", modules=[("labels", LABELS_SRC, "labels.py")],
        machines=())
    lines = LABELS_SRC.splitlines()
    got = []
    for f in findings:
        assert f.rule == "host_blocking" and f.where.endswith("(_fetch)")
        label = f.message.split(": ", 1)[1].split(" in _fetch")[0]
        lineno = int(f.where.split(":")[1].split()[0])
        got.append((label, lines[lineno - 1].strip()))
    assert got == [
        (".cpu", "a = self.t.cpu()"), (".item", "b = self.t.item()"),
        (".tolist", "c = self.t.tolist()"),
        (".numpy", "d = self.t.numpy()"),
        ('.to("cpu")', 'e = self.t.to("cpu")'),
        ('.to("cpu")', 'f = self.t.to(device="cpu")'),
        ("torch.cuda.synchronize", "torch.cuda.synchronize()"),
        (".synchronize", "self.stream.synchronize()"),
        ("dist.all_reduce", "dist.all_reduce(self.t)"),
        ("torch.distributed.broadcast",
         "torch.distributed.broadcast(self.t, 0)"),
        ("np.asarray", "i = np.asarray(self.host)")]
    assert hc.host_contracts_summary(sections)["blocking"] == len(got)


def test_port_modules_pinned(monkeypatch):
    """The port's engine and fleet: exactly the reviewed journal overlap
    (stats / _jdirty / _jentries x the three step methods) and the one
    host-resident conversion in journal_entry, every one allowlisted with
    the port's reasons, the raw count at the budget's ceiling, and both
    machines clean and fully covered."""
    monkeypatch.setattr(hc, "_CACHE", {})
    findings, sections = hc.check_host_contracts(target="host")
    assert [f for f in findings if f.rule not in (
        "host_race", "host_blocking")] == []
    races = [f for f in findings if f.rule == "host_race"]
    assert sorted((f.where.split("(")[1].rstrip(")"),
                   f.message.split("self.")[1].split(" ")[0])
                  for f in races) == sorted(
        (f"ContinuousBatchingEngine.{m}", field)
        for m in ("step", "_mixed_step", "_spec_step")
        for field in ("stats", "_jdirty", "_jentries"))
    blocking = [f for f in findings if f.rule == "host_blocking"]
    assert len(blocking) == 1 and blocking[0].where.startswith(
        "serving.py:") and blocking[0].where.endswith("(journal_entry)")
    assert ".tolist in journal_entry" in blocking[0].message
    report = Report("host", findings, allowlist=load_allowlist())
    assert report.ok and len(report.allowlisted) == 10
    # the port's own reasons, none copied from the reference's allowlist
    theirs = {a.reason for a in load_allowlist(REF_ALLOWLIST)}
    assert not {a.reason for _, a in report.allowlisted} & theirs
    summary = hc.host_contracts_summary(sections)
    assert summary["windows"] == 3 and summary["methods"] == 3
    assert summary["machines"] == 2 and summary["sites"] == 25
    (budget,) = load_budgets()
    assert budget.target == "host" and budget.reason
    assert summary["violations"] == budget.ceilings[
        "host_contract_violations"] == 10
    machines = {s["machine"]: s for s in sections if s["kind"] == "machine"}
    assert machines["request_lifecycle"]["sites"] == 20
    assert machines["replica_health"]["sites"] == 5
    for sec in machines.values():
        assert sec["dead_edges"] == [] and sec["undeclared"] == []
        assert sec["protocol"] == []
        assert sec["covered_edges"] == sec["declared_edges"]


def test_effect_analysis_deterministic(monkeypatch):
    monkeypatch.setattr(hc, "_CACHE", {})
    f1, s1 = hc.check_host_contracts(target="host")
    monkeypatch.setattr(hc, "_CACHE", {})   # force a true re-run
    f2, s2 = hc.check_host_contracts(target="host")
    assert _rows(f1) == _rows(f2) and s1 == s2
    # the memo returns equal but not aliased sections
    f3, s3 = hc.check_host_contracts(target="host")
    assert _rows(f3) == _rows(f2) and s3 == s2 and s3 is not s2
    s3[0]["windows"].append(-1)
    assert hc.check_host_contracts(target="host")[1] == s2


def test_host_verify_depth_env_knob_validated(monkeypatch):
    monkeypatch.setattr(envflags, "_warned", set())
    monkeypatch.delenv("PADDLE_TPU_HOST_VERIFY_DEPTH", raising=False)
    assert hc.host_verify_depth() == hc.DEFAULT_HOST_DEPTH == 8
    monkeypatch.setenv("PADDLE_TPU_HOST_VERIFY_DEPTH", "3")
    assert hc.host_verify_depth() == 3
    monkeypatch.setenv("PADDLE_TPU_HOST_VERIFY_DEPTH", "deep")
    with pytest.warns(UserWarning, match="HOST_VERIFY_DEPTH"):
        assert hc.host_verify_depth() == hc.DEFAULT_HOST_DEPTH
    monkeypatch.setenv("PADDLE_TPU_HOST_VERIFY_DEPTH", "0")
    with pytest.warns(UserWarning, match="minimum"):
        assert hc.host_verify_depth() == hc.DEFAULT_HOST_DEPTH


# ---------------------------------------------------------------------------
# the --host CLI
# ---------------------------------------------------------------------------

def _patch_fixture(monkeypatch, src, machines):
    monkeypatch.setattr(hc, "_CACHE", {})
    monkeypatch.setattr(hc, "_default_modules", lambda: _modules(src))
    monkeypatch.setattr(hc, "_default_machines", lambda: machines)


def _files(tmp_path, allow="# empty\n", ceiling=0,
           reason='reason = "fixture: zero tolerated violations"\n'):
    a = tmp_path / "allow.toml"
    a.write_text(allow)
    b = tmp_path / "budgets.toml"
    b.write_text(f'[[budget]]\ntarget = "host"\n'
                 f'host_contract_violations = {ceiling}\n{reason}')
    return ["--allowlist", str(a), "--budgets", str(b)]


def test_cli_green_and_json(capsys):
    assert cli.main(["--host"]) == 0
    out = capsys.readouterr().out
    assert "3 window(s)" in out and "25 transition site(s)" in out
    assert cli.main(["--host", "--json", "--strict-allowlist"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["exit"] == 0
    assert doc["host_contracts"]["violations"] == 10
    assert doc["budget"] == {"ceiling": 10, "violations": 10}
    for key in ("undeclared_transitions", "dead_edges", "protocol"):
        assert doc["host_contracts"][key] == 0
    assert len(doc["allowlisted"]) == 10 and doc["findings"] == []
    assert doc["stale_allowlist"] == [] and doc["budget_findings"] == []
    assert {s["kind"] for s in doc["sections"]} == {"overlap", "machine"}


def test_cli_no_allowlist_fails_on_the_real_modules(capsys):
    assert cli.main(["--host", "--no-allowlist"]) == 1
    out = capsys.readouterr().out
    assert "== host: 10 finding(s), 0 allowlisted ==" in out


@pytest.mark.parametrize("name,rule,needles", [
    ("race", "host_race", ("self._table", "FixtureEngine.step")),
    ("blocking", "host_blocking", ("np.asarray", "_sync_tokens")),
    ("health", "host_transition", ("DEAD->HEALTHY", "_heal")),
    ("resurrect", "host_transition", ("FINISHED->RUNNING", "retry")),
])
def test_cli_injected_violation_fails_by_name(monkeypatch, capsys, tmp_path,
                                              name, rule, needles):
    """Each injected violation fails the gate naming its field, edge or
    method, and the budget independently trips on the raw count."""
    src, kws, _, _ = FIXTURES[name]
    _patch_fixture(monkeypatch, src,
                   tuple(hc.MachineSpec(**kw) for kw in kws))
    assert cli.main(["--host", *_files(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert rule in out and "host_contract_violations 1 exceeds" in out
    for needle in needles:
        assert needle in out


def test_cli_raw_count_over_ceiling_fails(monkeypatch, capsys, tmp_path):
    """The race is allowlisted, but the ceiling still holds the raw count:
    an allowlist entry that over-matches cannot hide a new finding."""
    _patch_fixture(monkeypatch, SRC_RACE, ())
    allow = ('[[allow]]\nrule = "host_race"\nmatch = "self._table"\n'
             'reason = "fixture: reviewed"\n')
    assert cli.main(["--host", *_files(tmp_path, allow, 1)]) == 0
    capsys.readouterr()
    assert cli.main(["--host", "--json",
                     *_files(tmp_path, allow, 0)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and len(doc["allowlisted"]) == 1
    assert doc["budget"] == {"ceiling": 0, "violations": 1}
    assert "host_contract_violations 1 exceeds" in (
        doc["budget_findings"][0]["message"])


def test_cli_budget_entry_needs_a_reason(monkeypatch, capsys, tmp_path):
    _patch_fixture(monkeypatch, SRC_CLEAN, ())
    assert cli.main(["--host", *_files(tmp_path)]) == 0
    capsys.readouterr()
    assert cli.main(["--host", *_files(tmp_path, reason="")]) == 1
    assert "every budget needs a one-line reason" in capsys.readouterr().err
    with pytest.raises(ValueError, match="reason"):
        load_budgets(_files(tmp_path, reason="")[3])


def test_cli_budget_without_host_entry_fails(monkeypatch, capsys, tmp_path):
    _patch_fixture(monkeypatch, SRC_CLEAN, ())
    b = tmp_path / "other.toml"
    b.write_text('[[budget]]\ntarget = "serving_decode_step"\n'
                 'host_contract_violations = 0\nreason = "stale"\n')
    assert cli.main(["--host", "--budgets", str(b)]) == 1
    out = capsys.readouterr().out
    assert "stale budgets.toml entry" in out and "no host_contract" in out


def test_cli_stale_allowlist_entry_gates_under_strict(monkeypatch, capsys,
                                                      tmp_path):
    _patch_fixture(monkeypatch, SRC_STALE, ())
    allow = ('[[allow]]\nrule = "host_race"\n'
             'match = "self.retired_field"\n'
             'reason = "was reviewed; the race is long fixed"\n')
    files = _files(tmp_path, allow)
    assert cli.main(["--host", *files]) == 0
    assert "warning stale_allowlist" in capsys.readouterr().out
    assert cli.main(["--host", "--strict-allowlist", *files]) == 1
    out = capsys.readouterr().out
    assert "ERROR   stale_allowlist" in out and "host_race" in out


def test_allowlist_entry_needs_a_reason(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text('[[allow]]\nrule = "host_race"\nmatch = "x"\n')
    with pytest.raises(ValueError, match="reason"):
        load_allowlist(str(p))
    p.write_text('[[budget]]\ntarget = "host"\n')
    with pytest.raises(ValueError, match="unknown top-level"):
        load_allowlist(str(p))
    with pytest.raises(FileNotFoundError):
        load_allowlist(str(tmp_path / "missing.toml"))


@pytest.mark.parametrize("flag", [["--cards"], ["--all"],
                                  ["--target", "serving_decode_step"]])
def test_cli_refuses_the_jax_modes(capsys, flag):
    assert cli.main(["--host", *flag]) == 2
    assert "not ported" in capsys.readouterr().err
