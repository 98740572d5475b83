"""Analysis (counterpart of ``paddle_tpu/analysis/``), runtime half only.

Ported: the serving-engine auditor (``engine_audit.py``,
``PADDLE_TPU_ENGINE_AUDIT=1``), which cross-checks the engine's and the
fleet router's host state after every step.  Not ported: the reference's
jaxpr lint, its cost model, the static Pallas contracts (they read JAX
programs, which the port does not build) and ``host_contracts.py`` (the
AST pass over the serving modules; ROADMAP A13).
"""

from __future__ import annotations

from .engine_audit import (EngineAuditError, audit_enabled, audit_engine,
                           audit_fleet, audit_tier)

__all__ = ["EngineAuditError", "audit_enabled", "audit_engine",
           "audit_fleet", "audit_tier"]
