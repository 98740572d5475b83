"""CLI: ``python -m paddle_tpu_torch.analysis --host``.

The host-contract gate (counterpart of the reference CLI's ``--host``
mode): the AST effect/race analysis of the serving engine's
``_host_overlap()`` windows and the exhaustive protocol verification of
the fleet's health machine and the request lifecycle
(``host_contracts.py``), over the port's ``inference/serving.py`` and
``inference/fleet.py``; no engine is built and no tensor made.  Exit
status 0 when the gate holds, 1 when it fails:

* a finding the allowlist (``analysis/allowlist.toml``) does not cover;
* a raw finding count above ``budgets.toml``'s ``host_contract_violations``
  ceiling for target ``host``, no such entry, or an entry naming another
  target;
* a budget or allowlist file that does not load (an entry without a
  reason among them);
* under ``--strict-allowlist``, an allowlist entry that matched no finding
  (a fixed race whose suppression lingers).

``--json`` prints one machine-readable document instead of the text
(exit codes unchanged); ``--no-allowlist`` shows what the allowlist would
suppress; ``-v`` prints the allowlisted findings with their reasons.  The
reference's modes that trace JAX programs (``--target``, ``--all``,
``--cards``) are not ported: asked for one, the CLI says so and exits
2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from .report import Finding, Report, Severity

#: the reference CLI's modes that read compiled JAX programs
_UNPORTED = ("target", "all", "cards")


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis", allow_abbrev=False,
        description="host-contract gate over the port's serving engine and "
                    "fleet router")
    p.add_argument("--host", action="store_true",
                   help="host-contracts mode: AST effect/race analysis of "
                        "the async host runtime + state-machine protocol "
                        "verification")
    p.add_argument("--allowlist", default=None, metavar="PATH",
                   help="allowlist TOML (default: packaged allowlist.toml)")
    p.add_argument("--no-allowlist", action="store_true",
                   help="show findings the allowlist would suppress")
    p.add_argument("--budgets", default=None, metavar="PATH",
                   help="budgets TOML (default: packaged budgets.toml)")
    p.add_argument("--strict-allowlist", action="store_true",
                   help="an allowlist entry that matches no finding gates "
                        "instead of warning")
    p.add_argument("--json", action="store_true",
                   help="emit one machine-readable document on stdout "
                        "(exit codes unchanged)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="also print allowlisted findings with reasons")
    # the reference's JAX modes, recognized only to be refused by name
    p.add_argument("--target", action="append", default=[],
                   help=argparse.SUPPRESS)
    for flag in ("--all", "--cards"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    return p, p.parse_args(argv)


def _budget_findings(budgets, violations: int) -> tuple[list, int | None]:
    """Gate the raw count against the ``host`` entry: over the ceiling, no
    entry, or an entry for a target the port does not have all gate.
    Returns the findings and the ceiling (None without an entry)."""
    findings, ceiling = [], None
    for b in budgets:
        if b.target != "host":
            findings.append(Finding(
                rule="budget", severity=Severity.ERROR, target=b.target,
                message=f"stale budgets.toml entry: target {b.target!r} is "
                        f"not a pass of the port (only 'host') — delete "
                        f"the entry"))
            continue
        ceiling = b.ceilings.get("host_contract_violations")
    if ceiling is None:
        findings.append(Finding(
            rule="budget", severity=Severity.ERROR, target="host",
            message="no host_contract_violations ceiling for target "
                    "'host' in budgets.toml — the raw count must carry a "
                    "reviewed, reasoned ceiling"))
    elif violations > ceiling:
        findings.append(Finding(
            rule="budget", severity=Severity.ERROR, target="host",
            message=f"host_contract_violations {violations} exceeds its "
                    f"budgets.toml ceiling {ceiling} — a new race, host "
                    f"sync or state-machine finding; fix it, or review it "
                    f"and raise the ceiling with a reason"))
    return findings, ceiling


def _host_main(args) -> int:
    from .host_contracts import check_host_contracts, host_contracts_summary
    from .report import load_allowlist, load_budgets

    try:
        allowlist = ([] if args.no_allowlist
                     else load_allowlist(args.allowlist))
        budgets = load_budgets(args.budgets)
    except (OSError, ValueError) as e:
        print(f"host-contract gate FAILED: cannot load allowlist/budgets: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    findings, sections = check_host_contracts(target="host")
    secs = time.perf_counter() - t0
    report = Report("host", findings, allowlist=allowlist)
    summary = host_contracts_summary(sections)
    budget, ceiling = _budget_findings(budgets, summary["violations"])
    used = {id(a) for _, a in report.allowlisted}
    stale = [a for a in allowlist if id(a) not in used]
    rc = 0 if report.ok and not budget else 1
    if stale and args.strict_allowlist:
        rc = 1
    if args.json:
        print(json.dumps(
            {"host_contracts": summary, "sections": sections,
             "seconds": round(secs, 3), "ok": rc == 0, "exit": rc,
             "budget": {"ceiling": ceiling,
                        "violations": summary["violations"]},
             "budget_findings": [dataclasses.asdict(f) for f in budget],
             "stale_allowlist": [
                 {"rule": a.rule, "target": a.target, "match": a.match,
                  "gating": args.strict_allowlist} for a in stale],
             "findings": [dataclasses.asdict(f) for f in report.findings],
             "allowlisted": [{**dataclasses.asdict(f), "reason": a.reason}
                             for f, a in report.allowlisted]}, indent=2))
        return rc
    print(f"-- host contracts: {summary['methods']} overlap method(s) "
          f"/ {summary['windows']} window(s), {summary['machines']} "
          f"state machine(s) / {summary['sites']} transition site(s); "
          f"{summary['races']} race(s), {summary['blocking']} blocking "
          f"fetch(es), {summary['undeclared_transitions']} undeclared "
          f"transition(s), {summary['dead_edges']} dead edge(s), "
          f"{summary['protocol']} protocol finding(s) --")
    for s in sections:
        if s.get("kind") == "overlap":
            print(f"   overlap {s['method']} "
                  f"windows={s['windows']} "
                  f"races={[r['field'] for r in s['races']]} "
                  f"blocking={len(s['blocking'])} [{s['where']}]")
        else:
            print(f"   machine {s['machine']} sites={s['sites']} "
                  f"edges {len(s['covered_edges'])}/"
                  f"{len(s['declared_edges'])} covered "
                  f"dead={s['dead_edges']} "
                  f"undeclared={len(s['undeclared'])} "
                  f"protocol={len(s['protocol'])}")
    print(report.render(verbose=args.verbose))
    print(f"   budget: host_contract_violations {summary['violations']} "
          f"(ceiling {ceiling}); pass {secs:.3f} s")
    for f in budget:
        print("  " + f.render())
    for a in stale:
        line = (f"allowlist entry matched no finding (rule={a.rule!r} "
                f"target={a.target!r} match={a.match!r}) — the suppressed "
                f"finding was fixed or renamed; delete the entry (reason "
                f"on file: {a.reason[:80]})")
        if args.strict_allowlist:
            print(f"  ERROR   stale_allowlist: {line}")
        else:
            print(f"  warning stale_allowlist: {line} "
                  f"(gating under --strict-allowlist)")
    if rc:
        print("\nhost-contract gate FAILED: fix the race/transition, or "
              "allowlist it in paddle_tpu_torch/analysis/allowlist.toml "
              "with a reason and review the ceiling in budgets.toml",
              file=sys.stderr)
    return rc


def main(argv=None) -> int:
    p, args = _parse(sys.argv[1:] if argv is None else list(argv))
    asked = [m for m in _UNPORTED if getattr(args, m)]
    if asked:
        flags = ", ".join("--" + m.replace("_", "-") for m in asked)
        print(f"python -m paddle_tpu_torch.analysis: {flags}: not ported — "
              f"the reference's lint, program cards and budgets trace "
              f"compiled JAX programs, which the port does not build; "
              f"only --host is available", file=sys.stderr)
        return 2
    if not args.host:
        p.error("pass --host (the only mode of the port's analysis CLI)")
    return _host_main(args)


if __name__ == "__main__":
    sys.exit(main())
