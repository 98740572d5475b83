"""Findings, reports, the allowlist and the host budget of the port's
static passes (counterpart of ``paddle_tpu/analysis/report.py``).

A :class:`Finding` is one typed diagnostic (rule, severity, message,
provenance).  A :class:`Report` partitions one pass's findings into
active and allowlisted; ``python -m paddle_tpu_torch.analysis --host``
exits non-zero on any active finding at or above ``warning``.

The allowlist (``analysis/allowlist.toml``) records *accepted* findings,
each with a one-line reason: every suppression is visible and reviewed in
one file.  The budget file (``analysis/budgets.toml``) pins the raw count
of the host-contract pass (``host_contract_violations``), so a new
finding moves the figure even where an allowlist entry over-matches.
Both are read with ``tomllib``; a key, a table or a value the format does
not define is a loud error, since a silently ignored line would
un-suppress a finding or un-gate a ceiling.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib

__all__ = ["Severity", "Finding", "Report", "AllowRule", "load_allowlist",
           "DEFAULT_ALLOWLIST", "BudgetEntry", "load_budgets",
           "DEFAULT_BUDGETS", "CEILING_KEYS"]

# severity order for gating: info findings are advisory and never fail the
# gate; warning/error do unless allowlisted
_SEV_ORDER = {"info": 0, "warning": 1, "error": 2}

_HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_ALLOWLIST = os.path.join(_HERE, "allowlist.toml")
DEFAULT_BUDGETS = os.path.join(_HERE, "budgets.toml")

#: the ceilings a budget entry may carry: the port has no program cards,
#: so the host pass's raw count is the only one
CEILING_KEYS = ("host_contract_violations",)


class Severity:
    INFO = "info"
    WARNING = "warning"
    ERROR = "error"


@dataclasses.dataclass
class Finding:
    """One typed finding.

    ``rule``: host_race | host_blocking | host_transition | host_dead_edge
    | host_protocol (``host_contracts.py``).  ``where`` is the provenance
    (``file.py:line (fn)``), or the machine's name for a finding about a
    declared table.
    """

    rule: str
    severity: str
    message: str
    where: str = ""
    target: str = ""

    def render(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.severity.upper():7s} {self.rule}: {self.message}{loc}"


@dataclasses.dataclass
class AllowRule:
    """One ``[[allow]]`` entry: rule + optional target + substring match."""

    rule: str = "*"
    target: str = "*"
    match: str = ""
    reason: str = ""

    def covers(self, f: Finding) -> bool:
        if self.rule not in ("*", f.rule):
            return False
        if self.target not in ("*", "", f.target):
            return False
        return (not self.match or self.match in f.where
                or self.match in f.message)


def _read_tables(path: str, header: str) -> list[dict]:
    """The ``[[<header>]]`` array of tables of a TOML file; any other
    top-level key is an error."""
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    other = sorted(set(doc) - {header})
    if other:
        raise ValueError(f"{path}: unknown top-level key(s) {other} "
                         f"(expected only [[{header}]] tables)")
    entries = doc.get(header, [])
    if not isinstance(entries, list):
        raise ValueError(f"{path}: {header!r} must be an array of tables "
                         f"([[{header}]])")
    return entries


def load_allowlist(path: str | None = None) -> list[AllowRule]:
    """Load allow rules; a missing default file is an empty allowlist, a
    missing *explicit* path is an error (a typoed --allowlist must not
    silently allow nothing)."""
    explicit = path is not None
    path = path or DEFAULT_ALLOWLIST
    if not os.path.exists(path):
        if explicit:
            raise FileNotFoundError(f"allowlist file not found: {path}")
        return []
    rules = []
    for i, e in enumerate(_read_tables(path, "allow")):
        unknown = set(e) - {"rule", "target", "match", "reason"}
        if unknown:
            raise ValueError(f"allowlist entry {i}: unknown keys {unknown}")
        bad = {k for k, v in e.items() if not isinstance(v, str)}
        if bad:
            raise ValueError(f"allowlist entry {i}: non-string value(s) for "
                             f"{sorted(bad)} (budgets live in budgets.toml)")
        if not e.get("reason"):
            raise ValueError(
                f"allowlist entry {i} ({e}): every suppression needs a "
                f"one-line reason")
        rules.append(AllowRule(**e))
    return rules


@dataclasses.dataclass
class BudgetEntry:
    """One ``[[budget]]`` table: a target's ceilings + REQUIRED reason."""

    target: str
    ceilings: dict
    reason: str


def load_budgets(path: str | None = None) -> list[BudgetEntry]:
    """Load the budget file; a missing default file is an empty budget set
    (the gate then reports the host pass as un-budgeted), a missing
    EXPLICIT path is an error, as for the allowlist.  An entry without a
    target or a reason, a duplicate target, an unknown ceiling or a
    non-integer one raises ``ValueError``."""
    explicit = path is not None
    path = path or DEFAULT_BUDGETS
    if not os.path.exists(path):
        if explicit:
            raise FileNotFoundError(f"budgets file not found: {path}")
        return []
    out: list[BudgetEntry] = []
    seen: set[str] = set()
    for i, e in enumerate(_read_tables(path, "budget")):
        e = dict(e)
        target = e.pop("target", None)
        reason = e.pop("reason", "")
        if not isinstance(target, str) or not target:
            raise ValueError(f"budget entry {i}: missing target")
        if target in seen:
            raise ValueError(f"budget entry {i}: duplicate target "
                             f"{target!r} — one ceiling set per target")
        seen.add(target)
        if not reason or not isinstance(reason, str):
            raise ValueError(
                f"budget entry {i} ({target}): every budget needs a "
                f"one-line reason justifying its ceilings")
        unknown = set(e) - set(CEILING_KEYS)
        if unknown:
            raise ValueError(f"budget entry {i} ({target}): unknown "
                             f"ceiling keys {sorted(unknown)}; known: "
                             f"{sorted(CEILING_KEYS)}")
        bad = {k for k, v in e.items()
               if not isinstance(v, int) or isinstance(v, bool)}
        if bad:
            raise ValueError(f"budget entry {i} ({target}): non-integer "
                             f"ceiling(s) {sorted(bad)}")
        out.append(BudgetEntry(target=target, ceilings=e, reason=reason))
    return out


class Report:
    """Result of one pass over one target."""

    def __init__(self, target: str, findings: list[Finding],
                 allowlist: list[AllowRule] | None = None):
        self.target = target
        self.findings: list[Finding] = []       # active (not allowlisted)
        self.allowlisted: list[tuple[Finding, AllowRule]] = []
        for f in findings:
            rule = next((a for a in (allowlist or []) if a.covers(f)), None)
            if rule is None:
                self.findings.append(f)
            else:
                self.allowlisted.append((f, rule))

    @property
    def ok(self) -> bool:
        """True when no active finding gates (info is advisory)."""
        return not self.gating()

    def gating(self) -> list[Finding]:
        return [f for f in self.findings
                if _SEV_ORDER[f.severity] >= _SEV_ORDER["warning"]]

    def render(self, verbose: bool = False) -> str:
        lines = [f"== {self.target}: {len(self.findings)} finding(s), "
                 f"{len(self.allowlisted)} allowlisted =="]
        for f in self.findings:
            lines.append("  " + f.render())
        if verbose:
            for f, a in self.allowlisted:
                lines.append(f"  ALLOWED {f.render().strip()}  "
                             f"(reason: {a.reason})")
        return "\n".join(lines)
