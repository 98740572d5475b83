"""Analysis (counterpart of ``paddle_tpu/analysis/``): A13's runtime and
host halves.

Ported:

* the serving-engine auditor (``engine_audit.py``,
  ``PADDLE_TPU_ENGINE_AUDIT=1``), which cross-checks the engine's and the
  fleet router's host state after every step;
* the host-contract pass (``host_contracts.py``): the static effect/race
  analysis of the engine's ``_host_overlap()`` windows and the protocol
  check of the request lifecycle and the fleet's health machine, with its
  findings, reports and allowlist (``report.py``, ``allowlist.toml``), its
  raw-count ceiling (``budgets.toml``) and its gate, ``python -m
  paddle_tpu_torch.analysis --host`` (``__main__.py``).  Its host-sync
  labels are torch's (ROADMAP C18).

Not ported: the reference's jaxpr lint (``rules.py``), its cost model and
program cards (``cost_model.py``), its target registry (``targets.py``)
and the static Pallas contracts (``kernel_contracts.py``): they read
compiled JAX programs and Pallas kernels, which the port does not build
(ROADMAP A13).
"""

from __future__ import annotations

from .engine_audit import (EngineAuditError, audit_enabled, audit_engine,
                           audit_fleet, audit_tier)
from .host_contracts import (check_host_contracts, host_contracts_summary,
                             host_verify_depth)
from .report import Finding, Report, Severity, load_allowlist, load_budgets

__all__ = ["EngineAuditError", "audit_enabled", "audit_engine",
           "audit_fleet", "audit_tier", "check_host_contracts",
           "host_contracts_summary", "host_verify_depth", "Finding",
           "Report", "Severity", "load_allowlist", "load_budgets"]
