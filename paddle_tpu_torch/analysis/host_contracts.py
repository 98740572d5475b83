"""Host contracts (counterpart of ``paddle_tpu/analysis/host_contracts.py``):
static effect/race analysis of the serving engine's async host runtime
plus exhaustive protocol verification of the fleet and request state
machines.

The kernels are held against their plain versions on the card; what
remains is host-side Python: ``_host_overlap()`` mutates engine state
while the card executes a step's queued launches, and the fleet's health
machine and the request lifecycle grow transitions with every
fault-tolerance change.  This pass verifies both statically, on the
modules' AST: no engine build, no tensor, deterministic across runs.

1. **Effect/race analysis of the overlap window.**  For every class that
   defines ``_host_overlap()``, each call site's enclosing step method is
   split at the call line: the *lexical prefix* (the code that built the
   in-flight launches' operands) and the *overlap closure* (everything
   reachable from ``_host_overlap`` through the self-call graph, bounded
   by ``PADDLE_TPU_HOST_VERIFY_DEPTH``).  Any ``self.*`` field read in the
   prefix and written in the overlap closure is a host/device pipeline
   race (``host_race``): the overlap bookkeeping mutates state the launch
   was built from.  Deliberate overlaps (the incremental journal's own
   fields) are carried as reasoned ``allowlist.toml`` entries with a raw
   ``host_contract_violations`` ceiling in ``budgets.toml``, so a NEW race
   moves the budgeted figure even if an allowlist entry over-matches.  A
   host synchronization reachable from the window is ``host_blocking``:
   it would serialize the pipeline the window exists to overlap.  The
   labels are torch's host syncs (``.cpu()``, ``.item()``, ``.tolist()``,
   ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize``, a stream's or
   an event's ``.synchronize()``, a ``torch.distributed`` collective
   without ``async_op=True``) beside the reference's ``np.asarray``.
   Implicit syncs (``float(t)``, ``if t:``, ``.nonzero()``) cannot be
   typed from the AST; ``chip_smoke.py`` runs every window on the card
   under ``torch.cuda.set_sync_debug_mode("error")`` for those.

2. **Exhaustive protocol verification.**  The replica health machine
   (``fleet.HEALTH_EDGES`` over ``REPLICA_STATES``) and the request
   lifecycle (``serving.REQUEST_EDGES`` over PENDING/RUNNING +
   ``TERMINAL_STATUSES``) are declared transition tables beside the code.
   Every assignment site of the state field (direct literal stores,
   choke-point calls: ``_health_to``, ``_terminal`` and any function that
   forwards a status parameter into one), each under its dominating guard
   constraints, must map to a declared edge (``host_transition``
   otherwise), and every declared edge must have at least one site
   (``host_dead_edge`` otherwise).  Mirror stores (``f.status =
   c.status``) are safe by induction and exempt-but-reported.  The
   declared tables themselves are model-checked by enumeration
   (``host_protocol``): terminal states absorbing, every state reachable
   from the initial state, every non-terminal state able to reach a
   terminal, and, for ladder machines, strictly monotone degradation
   with an explicit heal-edge whitelist (HEALTHY->DEGRADED->DRAINING->DEAD
   with only DEGRADED->HEALTHY climbing back).

Findings flow through the severity/allowlist machinery of ``report.py``;
``python -m paddle_tpu_torch.analysis --host`` gates them, and their raw
count against ``budgets.toml``.  Finding texts are the reference's, so
the two passes compare finding for finding.
"""

from __future__ import annotations

import ast
import copy as _copy
import dataclasses

from .report import Finding, Severity
from ..utils.envflags import env_int

__all__ = ["check_host_contracts", "host_contracts_summary",
           "host_verify_depth", "MachineSpec", "DEFAULT_HOST_DEPTH"]

#: default call-graph resolution depth (edges followed from the overlap
#: window / choke chain); PADDLE_TPU_HOST_VERIFY_DEPTH overrides, min 1
DEFAULT_HOST_DEPTH = 8


def host_verify_depth() -> int:
    """Validated PADDLE_TPU_HOST_VERIFY_DEPTH (utils/envflags.py): a typo
    or sub-minimum value warns once and keeps the default — a
    misconfigured depth must not silently shrink the effect closure to
    nothing (races hidden) or explode it."""
    return env_int("PADDLE_TPU_HOST_VERIFY_DEPTH", DEFAULT_HOST_DEPTH,
                   minimum=1)


#: container-mutating method names: ``self.x.<name>(...)`` WRITES x (and
#: reads it — the mutation starts from the current value)
_MUTATORS = frozenset({
    "append", "appendleft", "add", "extend", "update", "pop", "popitem",
    "popleft", "clear", "discard", "remove", "insert", "setdefault", "sort",
    "fill"})


#: tensor methods that copy device memory to the host and wait for it
_SYNC_METHODS = frozenset({"cpu", "item", "tolist", "numpy"})

#: torch.distributed collectives: called without ``async_op=True`` each
#: returns only when the collective is done (gloo stages a CUDA tensor
#: through the host, so the host waits for the card too)
_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "barrier",
    "monitored_barrier", "broadcast", "broadcast_object_list", "gather",
    "gather_object", "reduce", "reduce_scatter", "reduce_scatter_tensor",
    "scatter", "scatter_object_list", "send", "recv"})


def _dotted(node) -> str | None:
    """``a.b.c`` for a chain of names and attributes, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _is_cpu(node) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value.split(":")[0] == "cpu")


def _blocking_label(call: ast.Call) -> str | None:
    """Name a host synchronization: np.asarray / numpy.asarray (the
    reference's label, kept so that its fixtures compare), ``.cpu()``,
    ``.item()``, ``.tolist()``, ``.numpy()``, ``.to("cpu")`` /
    ``.to(device="cpu")``, ``torch.cuda.synchronize``, any other
    ``.synchronize()`` (a stream's or an event's), and a
    ``torch.distributed`` collective (through ``dist`` or
    ``torch.distributed``) without ``async_op=True``.  (``torch.as_tensor
    (..., device=...)`` and ``.to("cuda")`` are host-to-device copies,
    queued on the stream, and deliberately NOT matched.)"""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    base = _dotted(fn.value)
    if fn.attr == "asarray" and base in ("np", "numpy"):
        return f"{base}.asarray"
    if fn.attr == "synchronize":
        return ("torch.cuda.synchronize" if base == "torch.cuda"
                else ".synchronize")
    if fn.attr in _COLLECTIVES and base in ("dist", "torch.distributed"):
        if any(kw.arg == "async_op" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords):
            return None
        return f"{base}.{fn.attr}"
    if fn.attr in _SYNC_METHODS:
        return f".{fn.attr}"
    if fn.attr == "to" and (
            (call.args and _is_cpu(call.args[0]))
            or any(kw.arg == "device" and _is_cpu(kw.value)
                   for kw in call.keywords)):
        return '.to("cpu")'
    return None


class _Effects(ast.NodeVisitor):
    """Per-function ``self.*`` read/write sets, self-call + module-call
    names, and blocking-fetch sites."""

    def __init__(self):
        self.reads: set[str] = set()
        self.writes: set[str] = set()
        self.calls: set[str] = set()
        self.blocking: list[tuple[str, int]] = []   # (label, lineno)

    def _self_attr(self, node) -> str | None:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def visit_Attribute(self, node):
        attr = self._self_attr(node)
        if attr is not None:
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self.writes.add(attr)
            else:
                self.reads.add(attr)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        # self.x[i] = v / del self.x[i]: a write THROUGH x (x itself read)
        attr = self._self_attr(node.value)
        if attr is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
            self.writes.add(attr)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        t = node.target
        attr = self._self_attr(t)
        if attr is None and isinstance(t, ast.Subscript):
            attr = self._self_attr(t.value)
        if attr is not None:
            self.reads.add(attr)
            self.writes.add(attr)
        self.generic_visit(node)

    def visit_Call(self, node):
        label = _blocking_label(node)
        if label is not None:
            self.blocking.append((label, node.lineno))
        fn = node.func
        if isinstance(fn, ast.Attribute):
            attr = self._self_attr(fn.value)
            if attr is not None:
                # self.x.append(...): mutator call writes x
                if fn.attr in _MUTATORS:
                    self.writes.add(attr)
            elif self._self_attr(fn) is not None:
                self.calls.add(fn.attr)     # self.method(...)
        elif isinstance(fn, ast.Name):
            self.calls.add(fn.id)           # module-level function
        self.generic_visit(node)


def _effects_of(nodes) -> _Effects:
    eff = _Effects()
    for n in nodes:
        eff.visit(n)
    return eff


def _collect_prefix(body, before_line: int, out: list) -> None:
    """The lexical prefix of a method at ``before_line``: every statement
    (recursively, through compound statements) that STARTS before the
    overlap call — the over-approximation of "code that ran before the
    launch returned", operand reads included."""
    for stmt in body:
        if getattr(stmt, "lineno", before_line) >= before_line:
            continue
        if isinstance(stmt, ast.If):
            out.append(stmt.test)
            _collect_prefix(stmt.body, before_line, out)
            _collect_prefix(stmt.orelse, before_line, out)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            out.append(stmt.iter)
            _collect_prefix(stmt.body, before_line, out)
            _collect_prefix(stmt.orelse, before_line, out)
        elif isinstance(stmt, ast.While):
            out.append(stmt.test)
            _collect_prefix(stmt.body, before_line, out)
            _collect_prefix(stmt.orelse, before_line, out)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                out.append(item.context_expr)
            _collect_prefix(stmt.body, before_line, out)
        elif isinstance(stmt, ast.Try):
            _collect_prefix(stmt.body, before_line, out)
            for h in stmt.handlers:
                _collect_prefix(h.body, before_line, out)
            _collect_prefix(stmt.orelse, before_line, out)
            _collect_prefix(stmt.finalbody, before_line, out)
        else:
            out.append(stmt)


@dataclasses.dataclass
class _Module:
    name: str                       # short module name ("serving", "fleet")
    filename: str                   # for finding provenance
    tree: ast.Module = None
    classes: dict = None            # cls name -> {method name -> FunctionDef}
    functions: dict = None          # module-level name -> FunctionDef


def _parse_module(name: str, source: str, filename: str) -> _Module:
    tree = ast.parse(source, filename=filename)
    classes, functions = {}, {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            classes[node.name] = {
                n.name: n for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            functions[node.name] = node
    return _Module(name=name, filename=filename, tree=tree,
                   classes=classes, functions=functions)


def _where(mod: _Module, lineno: int, fn: str = "") -> str:
    base = mod.filename.rsplit("/", 1)[-1]
    return f"{base}:{lineno}" + (f" ({fn})" if fn else "")


# ---------------------------------------------------------------------------
# effect/race analysis of the _host_overlap() window
# ---------------------------------------------------------------------------

def _closure(seeds, methods: dict, functions: dict, depth: int):
    """Breadth-first self-call/module-call closure from ``seeds`` (method
    names), following at most ``depth`` call edges.  Returns
    {name: _Effects} for every resolved function in the closure."""
    resolved: dict[str, _Effects] = {}
    frontier = [s for s in seeds]
    for _ in range(depth + 1):
        if not frontier:
            break
        nxt = []
        for name in frontier:
            if name in resolved:
                continue
            node = methods.get(name) or functions.get(name)
            if node is None:
                continue        # stdlib/np/torch call — out of scope
            eff = _effects_of(node.body)
            resolved[name] = eff
            nxt.extend(sorted(eff.calls))
        frontier = nxt
    return resolved


def _check_overlap(mod: _Module, overlap: str, depth: int, raw: list,
                   sections: list) -> None:
    for cls_name in sorted(mod.classes):
        methods = mod.classes[cls_name]
        if overlap not in methods:
            continue
        ov_closure = _closure([overlap], methods, mod.functions, depth)
        ov_writes: set[str] = set()
        writers: dict[str, list] = {}
        ov_blocking: list[tuple[str, str, int]] = []   # (fn, label, lineno)
        for fname in sorted(ov_closure):
            eff = ov_closure[fname]
            for w in eff.writes:
                ov_writes.add(w)
                writers.setdefault(w, []).append(fname)
            for label, lineno in eff.blocking:
                ov_blocking.append((fname, label, lineno))
        ov_blocking.sort(key=lambda b: (b[2], b[0]))

        # one analysis unit per (method containing >= 1 window); both
        # graceful/serial window sites of a step method share one prefix
        # approximation, so findings dedupe on (method, field)
        sites: dict[str, list[int]] = {}
        for mname in sorted(methods):
            if mname == overlap:
                continue
            for node in ast.walk(methods[mname]):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == overlap
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"):
                    sites.setdefault(mname, []).append(node.lineno)

        blocked_reported: set[tuple[str, int]] = set()
        for mname in sorted(sites):
            lines = sorted(sites[mname])
            prefix_nodes: list = []
            _collect_prefix(methods[mname].body, lines[0], prefix_nodes)
            pre = _effects_of(prefix_nodes)
            pre_reads = set(pre.reads)
            pre_closure = _closure(sorted(pre.calls), methods,
                                   mod.functions, depth)
            for eff in pre_closure.values():
                pre_reads |= eff.reads
            races = sorted(pre_reads & ov_writes)
            n_findings = 0
            for field in races:
                wby = ", ".join(sorted(set(writers[field])))
                raw.append((
                    "host_race", Severity.ERROR,
                    f"host/device pipeline race: self.{field} is read "
                    f"while building {cls_name}.{mname}'s launch and "
                    f"written inside the {overlap}() window (by {wby}) "
                    f"while the device step is in flight — overlap "
                    f"bookkeeping must not touch launch-read state "
                    f"(a deliberate journal overlap needs a reasoned "
                    f"allowlist.toml entry)",
                    _where(mod, lines[0], f"{cls_name}.{mname}")))
                n_findings += 1
            sec_blocking = []
            for fname, label, lineno in ov_blocking:
                sec_blocking.append(f"{label} in {fname} "
                                    f"[{_where(mod, lineno)}]")
                if (fname, lineno) in blocked_reported:
                    continue
                blocked_reported.add((fname, lineno))
                raw.append((
                    "host_blocking", Severity.ERROR,
                    f"blocking device fetch reachable from the "
                    f"{overlap}() window: {label} in {fname} — the window "
                    f"runs while the device step is in flight, so a "
                    f"blocking fetch serializes the host/device pipeline "
                    f"it exists to overlap",
                    _where(mod, lineno, fname)))
                n_findings += 1
            sections.append({
                "kind": "overlap",
                "method": f"{cls_name}.{mname}",
                "where": _where(mod, lines[0]),
                "windows": lines,
                "launch_reads": len(pre_reads),
                "overlap_writes": sorted(ov_writes),
                "races": [{"field": f,
                           "writers": sorted(set(writers[f]))}
                          for f in races],
                "blocking": sec_blocking,
                "findings": n_findings,
            })


# ---------------------------------------------------------------------------
# protocol verification: declared transition tables vs assignment sites
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """One declared state machine: the states, the transition table
    (declared beside the code it governs), and how its assignment sites
    look in the AST.

    ``kind``: ``"attr"`` — the state lives in ``<obj>.<field>`` (the
    request lifecycle's ``req.status``); ``"self_index"`` — in
    ``self.<field>[<subject>]`` (the fleet's ``self.health[r]``).
    ``default_sources`` are the source states assumed at a site with no
    dominating guard on the state expression (with ``default_reason``
    naming why that assumption is sound).  ``named_sets`` resolves
    ``in <NAME>`` guards (e.g. ``in TERMINAL_STATUSES``).  ``ladder``,
    when set, model-checks strictly monotone degradation with
    ``heal_edges`` the only edges allowed to climb back."""

    name: str
    field: str
    kind: str
    states: tuple
    edges: frozenset
    terminal: frozenset
    initial: str
    default_sources: frozenset
    default_reason: str = ""
    named_sets: dict = dataclasses.field(default_factory=dict)
    ladder: tuple | None = None
    heal_edges: frozenset = frozenset()


def _state_key(node, m: MachineSpec) -> str | None:
    """The guard-matching key of a state READ expression: for attr
    machines the owning object (``req`` in ``req.status``), for
    self_index machines the subject index (``r`` in ``self.health[r]``)."""
    if m.kind == "attr":
        if isinstance(node, ast.Attribute) and node.attr == m.field:
            return ast.dump(node.value)
    else:
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == m.field
                and isinstance(node.value.value, ast.Name)
                and node.value.value.id == "self"):
            return ast.dump(node.slice)
    return None


def _resolve_states(node, m: MachineSpec) -> frozenset | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return frozenset({node.value})
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = set()
        for e in node.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
                return None
            vals.add(e.value)
        return frozenset(vals)
    if isinstance(node, ast.Name) and node.id in m.named_sets:
        return frozenset(m.named_sets[node.id])
    return None


def _constraints(test, m: MachineSpec, positive: bool) -> list:
    """Extract (key, allowed-state-set) facts from a guard expression.
    Sound under negation: ``and`` decomposes positively, ``or``
    negatively; anything unrecognized contributes nothing."""
    out = []
    if isinstance(test, ast.BoolOp):
        decomposes = (isinstance(test.op, ast.And) if positive
                      else isinstance(test.op, ast.Or))
        if decomposes:
            for v in test.values:
                out += _constraints(v, m, positive)
        return out
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _constraints(test.operand, m, not positive)
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        key = _state_key(test.left, m)
        if key is None:
            return out
        lits = _resolve_states(test.comparators[0], m)
        if lits is None:
            return out
        op = test.ops[0]
        if isinstance(op, (ast.Eq, ast.In)):
            allowed = set(lits)
        elif isinstance(op, (ast.NotEq, ast.NotIn)):
            allowed = set(m.states) - set(lits)
        else:
            return out
        if not positive:
            allowed = set(m.states) - allowed
        out.append((key, frozenset(allowed)))
    return out


def _always_exits(body) -> bool:
    return bool(body) and isinstance(
        body[-1], (ast.Raise, ast.Return, ast.Continue, ast.Break))


@dataclasses.dataclass
class _Site:
    """One state-transition site: an assignment (or choke call) with its
    resolved destination and guard-narrowed source-state set."""

    mod: str
    where: str
    fn: str
    dest: str | None        # None = mirror
    sources: frozenset
    guarded: bool           # False -> default_sources applied
    mirror: bool = False


def _fn_params(node) -> list[str]:
    a = node.args
    return ([p.arg for p in a.posonlyargs] if hasattr(a, "posonlyargs")
            else []) + [p.arg for p in a.args]


def _match_store(target, m: MachineSpec):
    """Classify an assignment TARGET against the machine's state pattern.
    Returns (kind, key): kind ``"site"`` (per-subject store, key = guard
    key), ``"init"`` (whole-attr store of a self_index machine — initial
    population), or None."""
    if m.kind == "attr":
        if isinstance(target, ast.Attribute) and target.attr == m.field:
            return "site", ast.dump(target.value)
        return None
    if (isinstance(target, ast.Subscript)
            and isinstance(target.value, ast.Attribute)
            and target.value.attr == m.field
            and isinstance(target.value.value, ast.Name)
            and target.value.value.id == "self"):
        return "site", ast.dump(target.slice)
    if (isinstance(target, ast.Attribute) and target.attr == m.field
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"):
        return "init", None
    return None


def _find_chokes(mod: _Module, m: MachineSpec, depth: int) -> dict:
    """Choke-point discovery: functions that store a PARAMETER into the
    machine's state field (``_terminal``'s ``req.status = status``,
    ``_health_to``'s ``self.health[r] = state``), then — to fixpoint,
    depth-bounded — functions that forward one of their own parameters
    into a known choke's state position (``_fail_slot``).  Returns
    {(cls, fn): (state_param, subject_param | None)}."""
    chokes: dict = {}

    def scan_direct(cls, fname, node):
        params = _fn_params(node)
        for n in ast.walk(node):
            targets = []
            if isinstance(n, ast.Assign):
                targets, value = n.targets, n.value
            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                targets, value = [n.target], n.value
            else:
                continue
            for t in targets:
                mt = _match_store(t, m)
                if mt is None or mt[0] != "site":
                    continue
                if isinstance(value, ast.Name) and value.id in params:
                    subject = None
                    if m.kind == "attr":
                        if (isinstance(t.value, ast.Name)
                                and t.value.id in params):
                            subject = t.value.id
                    else:
                        sl = t.slice
                        if isinstance(sl, ast.Name) and sl.id in params:
                            subject = sl.id
                    chokes[(cls, fname)] = (value.id, subject)

    for cls in sorted(mod.classes):
        for fname in sorted(mod.classes[cls]):
            scan_direct(cls, fname, mod.classes[cls][fname])
    for fname in sorted(mod.functions):
        scan_direct(None, fname, mod.functions[fname])

    # forwarding chains: f(..., status, ...) -> choke(status) makes f a
    # choke too; bounded by depth iterations
    for _ in range(depth):
        grew = False
        for cls in sorted(mod.classes):
            for fname in sorted(mod.classes[cls]):
                if (cls, fname) in chokes:
                    continue
                node = mod.classes[cls][fname]
                params = _fn_params(node)
                for call in ast.walk(node):
                    if not isinstance(call, ast.Call):
                        continue
                    ck = _choke_of_call(call, cls, chokes)
                    if ck is None:
                        continue
                    state_arg, subj_arg = _choke_args(call, ck, chokes,
                                                      mod)
                    if (isinstance(state_arg, ast.Name)
                            and state_arg.id in params):
                        subject = (subj_arg.id
                                   if isinstance(subj_arg, ast.Name)
                                   and subj_arg.id in params else None)
                        chokes[(cls, fname)] = (state_arg.id, subject)
                        grew = True
                        break
        if not grew:
            break
    return chokes


def _choke_of_call(call: ast.Call, cls, chokes: dict):
    fn = call.func
    if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
            and fn.value.id == "self"):
        key = (cls, fn.attr)
        return key if key in chokes else None
    if isinstance(fn, ast.Name):
        key = (None, fn.id)
        return key if key in chokes else None
    return None


def _choke_args(call: ast.Call, choke_key, chokes: dict, mod: _Module):
    """The (state, subject) argument expressions of a call to a choke,
    resolved by the choke's own parameter names/positions."""
    cls, fname = choke_key
    node = (mod.classes[cls][fname] if cls is not None
            else mod.functions[fname])
    params = _fn_params(node)
    state_param, subject_param = chokes[choke_key]
    # methods are called through self: drop the leading 'self' param when
    # mapping positional call args
    offset = 1 if params and params[0] == "self" else 0

    def arg_for(pname):
        if pname is None:
            return None
        idx = params.index(pname) - offset
        if 0 <= idx < len(call.args):
            return call.args[idx]
        for kw in call.keywords:
            if kw.arg == pname:
                return kw.value
        return None

    return arg_for(state_param), arg_for(subject_param)


def _machine_sites(mod: _Module, m: MachineSpec, depth: int, raw: list):
    """Every transition site of machine ``m`` in ``mod``, guard-narrowed.
    Dynamic (unresolvable) stores raise ``host_transition`` findings
    directly into ``raw``."""
    chokes = _find_chokes(mod, m, depth)
    sites: list[_Site] = []
    inits: list[str] = []

    def classify_value(value, params, t):
        """-> ('literal', dest) | ('mirror', None) | ('choke-param', None)
        | ('dynamic', None)"""
        if isinstance(value, ast.Constant) and isinstance(value.value, str):
            return "literal", value.value
        if m.kind == "attr" and isinstance(value, ast.Attribute) \
                and value.attr == m.field:
            return "mirror", None
        if _state_key(value, m) is not None:
            return "mirror", None
        if isinstance(value, ast.Name) and value.id in params:
            return "choke-param", None
        return "dynamic", None

    def scan_fn(cls, fname, node):
        params = _fn_params(node)
        is_choke = (cls, fname) in chokes

        def handle_stmt(stmt, facts):
            for n in ast.walk(stmt):
                targets = []
                if isinstance(n, ast.Assign):
                    targets, value = n.targets, n.value
                elif isinstance(n, ast.AnnAssign) and n.value is not None:
                    targets, value = [n.target], n.value
                elif isinstance(n, ast.Call):
                    ck = _choke_of_call(n, cls, chokes)
                    if ck is None or (cls, fname) == ck:
                        continue
                    state_arg, subj_arg = _choke_args(n, ck, chokes, mod)
                    if state_arg is None:
                        continue
                    if (isinstance(state_arg, ast.Name)
                            and state_arg.id in params and is_choke):
                        continue      # forwarding edge; caller sites gate
                    if not (isinstance(state_arg, ast.Constant)
                            and isinstance(state_arg.value, str)):
                        raw.append((
                            "host_transition", Severity.ERROR,
                            f"[{m.name}] non-literal {m.field} transition "
                            f"passed into choke point "
                            f"{ck[1]}() — every transition site must name "
                            f"its destination state so the declared table "
                            f"can be verified",
                            _where(mod, n.lineno, fname)))
                        continue
                    subj_key = (ast.dump(subj_arg)
                                if subj_arg is not None else None)
                    _emit(n.lineno, state_arg.value, subj_key, facts)
                    continue
                else:
                    continue
                for t in targets:
                    mt = _match_store(t, m)
                    if mt is None:
                        continue
                    if mt[0] == "init":
                        lits = {c.value for c in ast.walk(value)
                                if isinstance(c, ast.Constant)
                                and isinstance(c.value, str)}
                        bad = sorted(lits - {m.initial})
                        if bad:
                            raw.append((
                                "host_protocol", Severity.ERROR,
                                f"[{m.name}] initial population of "
                                f"self.{m.field} uses state(s) {bad} — "
                                f"the machine starts at {m.initial!r}",
                                _where(mod, n.lineno, fname)))
                        inits.append(_where(mod, n.lineno, fname))
                        continue
                    kind, dest = classify_value(value, params, t)
                    if kind == "choke-param" and is_choke:
                        continue      # the choke body itself
                    if kind == "mirror":
                        sites.append(_Site(
                            mod=mod.name,
                            where=_where(mod, n.lineno, fname),
                            fn=fname, dest=None, sources=frozenset(),
                            guarded=False, mirror=True))
                        continue
                    if kind != "literal":
                        raw.append((
                            "host_transition", Severity.ERROR,
                            f"[{m.name}] dynamic {m.field} store (value "
                            f"not a state literal, a mirror of another "
                            f"{m.field}, or a verified choke parameter) — "
                            f"unverifiable against the declared "
                            f"transition table",
                            _where(mod, n.lineno, fname)))
                        continue
                    _emit(n.lineno, dest, mt[1], facts)

        def _emit(lineno, dest, subj_key, facts):
            srcs = set(m.states)
            guarded = False
            if subj_key is not None:
                for key, allowed in facts:
                    if key == subj_key:
                        srcs &= allowed
                        guarded = True
            if not guarded:
                srcs = set(m.default_sources)
            sites.append(_Site(
                mod=mod.name, where=_where(mod, lineno, fname), fn=fname,
                dest=dest, sources=frozenset(srcs), guarded=guarded))

        def walk_body(body, facts):
            facts = list(facts)
            for stmt in body:
                if isinstance(stmt, ast.If):
                    walk_body(stmt.body,
                              facts + _constraints(stmt.test, m, True))
                    walk_body(stmt.orelse,
                              facts + _constraints(stmt.test, m, False))
                    if _always_exits(stmt.body) and not stmt.orelse:
                        facts += _constraints(stmt.test, m, False)
                    continue
                if isinstance(stmt, ast.While):
                    walk_body(stmt.body,
                              facts + _constraints(stmt.test, m, True))
                    walk_body(stmt.orelse, facts)
                    continue
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    walk_body(stmt.body, facts)
                    walk_body(stmt.orelse, facts)
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    walk_body(stmt.body, facts)
                    continue
                if isinstance(stmt, ast.Try):
                    walk_body(stmt.body, facts)
                    for h in stmt.handlers:
                        walk_body(h.body, facts)
                    walk_body(stmt.orelse, facts)
                    walk_body(stmt.finalbody, facts)
                    continue
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                handle_stmt(stmt, facts)

        walk_body(node.body, [])

    for cls in sorted(mod.classes):
        for fname in sorted(mod.classes[cls]):
            scan_fn(cls, fname, mod.classes[cls][fname])
    for fname in sorted(mod.functions):
        scan_fn(None, fname, mod.functions[fname])

    # class-body field declarations (dataclass defaults) pin the initial
    # state: Request.status = "PENDING"
    for node in mod.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            if (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)
                    and stmt.target.id == m.field
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)):
                if stmt.value.value != m.initial:
                    raw.append((
                        "host_protocol", Severity.ERROR,
                        f"[{m.name}] {node.name}.{m.field} defaults to "
                        f"{stmt.value.value!r} — the machine starts at "
                        f"{m.initial!r}",
                        _where(mod, stmt.lineno, node.name)))
                inits.append(_where(mod, stmt.lineno, node.name))
    return sites, inits


def _model_check(m: MachineSpec) -> list[str]:
    """Enumerate the DECLARED table's invariants (no code involved)."""
    errs = []
    states = set(m.states)
    for s, d in sorted(m.edges):
        if s not in states or d not in states:
            errs.append(f"edge {s}->{d} names an unknown state "
                        f"(states: {sorted(states)})")
        if s in m.terminal:
            errs.append(f"terminal state {s} has outgoing edge {s}->{d} "
                        f"— terminal states are absorbing")
        if s == d:
            errs.append(f"self-loop {s}->{d} declared — self-transitions "
                        f"are implicit no-ops, not edges")
    # reachability from the initial state
    reach, frontier = {m.initial}, [m.initial]
    while frontier:
        s = frontier.pop()
        for a, b in m.edges:
            if a == s and b not in reach:
                reach.add(b)
                frontier.append(b)
    for s in sorted(states - reach):
        errs.append(f"state {s} is unreachable from {m.initial}")
    # every non-terminal state must be able to reach a terminal state
    if m.terminal:
        ok = set(m.terminal)
        grew = True
        while grew:
            grew = False
            for a, b in m.edges:
                if b in ok and a not in ok:
                    ok.add(a)
                    grew = True
        for s in sorted(states - ok):
            errs.append(f"state {s} cannot reach any terminal state "
                        f"({sorted(m.terminal)})")
    # degradation ladder: strictly monotone down, heals whitelisted
    if m.ladder is not None:
        rank = {s: i for i, s in enumerate(m.ladder)}
        for s, d in sorted(m.edges):
            if s in rank and d in rank and rank[d] <= rank[s] \
                    and (s, d) not in m.heal_edges:
                errs.append(
                    f"edge {s}->{d} climbs the degradation ladder "
                    f"{'->'.join(m.ladder)} without being a declared "
                    f"heal edge ({sorted(m.heal_edges) or 'none'})")
    return errs


def _check_machines(mods: list, machines, depth: int, raw: list,
                    sections: list) -> None:
    for m in machines:
        all_sites: list[_Site] = []
        inits: list[str] = []
        for mod in mods:
            s, i = _machine_sites(mod, m, depth, raw)
            all_sites += s
            inits += i
        covered: set = set()
        undeclared: list[str] = []
        for site in all_sites:
            if site.mirror:
                continue
            if site.dest not in m.states:
                raw.append((
                    "host_transition", Severity.ERROR,
                    f"[{m.name}] transition to unknown state "
                    f"{site.dest!r} (states: {sorted(m.states)})",
                    site.where))
                continue
            for src in sorted(site.sources):
                if src == site.dest:
                    continue    # self-transition: choke no-op, not an edge
                if (src, site.dest) in m.edges:
                    covered.add((src, site.dest))
                else:
                    undeclared.append(f"{src}->{site.dest} @ {site.where}")
                    raw.append((
                        "host_transition", Severity.ERROR,
                        f"[{m.name}] undeclared transition "
                        f"{src}->{site.dest}: the site "
                        f"{'is guarded to' if site.guarded else 'defaults to'} "
                        f"source state(s) {sorted(site.sources)} but the "
                        f"declared table has no {src}->{site.dest} edge — "
                        f"declare it (and re-model-check) or guard the "
                        f"site",
                        site.where))
        dead = sorted(m.edges - covered)
        for s, d in dead:
            raw.append((
                "host_dead_edge", Severity.ERROR,
                f"[{m.name}] declared edge {s}->{d} has no assignment "
                f"site in the code — a transition the table promises but "
                f"nothing performs; delete the edge or restore the site",
                f"{m.name}"))
        protocol = _model_check(m)
        for msg in protocol:
            raw.append(("host_protocol", Severity.ERROR,
                        f"[{m.name}] {msg}", m.name))
        n_sites = sum(1 for s in all_sites if not s.mirror)
        n_mirror = sum(1 for s in all_sites if s.mirror)
        sections.append({
            "kind": "machine",
            "machine": m.name,
            "states": list(m.states),
            "declared_edges": sorted(f"{s}->{d}" for s, d in m.edges),
            "sites": n_sites,
            "mirror_sites": n_mirror,
            "init_sites": sorted(inits),
            "covered_edges": sorted(f"{s}->{d}" for s, d in covered),
            "dead_edges": [f"{s}->{d}" for s, d in dead],
            "undeclared": sorted(undeclared),
            "protocol": protocol,
            "default_sources": sorted(m.default_sources),
            "findings": len(undeclared) + len(dead) + len(protocol),
        })


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _default_modules() -> list:
    from ..inference import fleet, serving

    out = []
    for mod in (serving, fleet):
        with open(mod.__file__) as f:
            src = f.read()
        out.append((mod.__name__.rsplit(".", 1)[-1], src, mod.__file__))
    return out


def _default_machines() -> tuple:
    from ..inference.fleet import HEALTH_EDGES, REPLICA_STATES
    from ..inference.serving import REQUEST_EDGES, TERMINAL_STATUSES

    request = MachineSpec(
        name="request_lifecycle", field="status", kind="attr",
        states=("PENDING", "RUNNING") + tuple(sorted(TERMINAL_STATUSES)),
        edges=frozenset(REQUEST_EDGES),
        terminal=frozenset(TERMINAL_STATUSES), initial="PENDING",
        default_sources=frozenset({"PENDING", "RUNNING"}),
        default_reason="engine/fleet registries hold only live requests — "
                       "_terminal/_finish pop the rid at the terminal "
                       "transition, so an unguarded site can only see "
                       "PENDING or RUNNING",
        named_sets={"TERMINAL_STATUSES": frozenset(TERMINAL_STATUSES)})
    health = MachineSpec(
        name="replica_health", field="health", kind="self_index",
        states=tuple(REPLICA_STATES), edges=frozenset(HEALTH_EDGES),
        terminal=frozenset({"DEAD"}), initial="HEALTHY",
        default_sources=frozenset(REPLICA_STATES),
        default_reason="every health write funnels through the _health_to "
                       "choke, which no-ops self-transitions; unguarded "
                       "callers (_kill) legitimately fire from any state",
        named_sets={"REPLICA_STATES": frozenset(REPLICA_STATES)},
        ladder=tuple(REPLICA_STATES),
        heal_edges=frozenset({("DEGRADED", "HEALTHY")}))
    return (request, health)


#: memoized default-module verification, keyed by depth — the pass is pure
#: AST over fixed sources, so every caller in one process shares one run
_CACHE: dict = {}


def _verify(modules, machines, overlap: str, depth: int):
    mods = [_parse_module(n, s, f) for (n, s, f) in modules]
    raw: list = []
    sections: list = []
    for mod in mods:
        _check_overlap(mod, overlap, depth, raw, sections)
    _check_machines(mods, machines, depth, raw, sections)
    return raw, sections


def check_host_contracts(target: str = "", *, modules=None, machines=None,
                         overlap: str = "_host_overlap",
                         depth: int | None = None):
    """Run the host-contract pass.  Returns ``(findings, sections)``:
    typed findings for the severity/allowlist machinery plus per-unit
    section dicts for ``--json``.

    ``modules`` (``[(name, source, filename), ...]``) and ``machines``
    (:class:`MachineSpec` s) default to the shipped engine + fleet and
    their declared tables; tests inject fixtures through them.  ``depth``
    bounds call-graph resolution (default:
    :func:`host_verify_depth`).  Pure AST — deterministic across runs and
    cheap enough to run at every gate (the default configuration is
    memoized)."""
    if depth is None:
        depth = host_verify_depth()
    if modules is None and machines is None:
        hit = _CACHE.get(depth)
        if hit is None:
            hit = _verify(_default_modules(), _default_machines(),
                          overlap, depth)
            _CACHE[depth] = hit
        raw, sections = hit
    else:
        raw, sections = _verify(
            modules if modules is not None else _default_modules(),
            machines if machines is not None else _default_machines(),
            overlap, depth)
    findings = [Finding(rule=r, severity=sev, message=msg, where=where,
                        target=target)
                for (r, sev, msg, where) in raw]
    return findings, _copy.deepcopy(sections)


def host_contracts_summary(sections) -> dict:
    """Aggregate host-contract verdicts for the CLI and ``chip_smoke.py``.
    ``violations`` counts RAW findings (pre-allowlist) — the figure
    ``budgets.toml`` ceilings as ``host_contract_violations``."""
    out = {"windows": 0, "methods": 0, "machines": 0, "sites": 0,
           "races": 0, "blocking": 0, "undeclared_transitions": 0,
           "dead_edges": 0, "protocol": 0, "violations": 0}
    for s in sections or ():
        if s.get("kind") == "overlap":
            out["methods"] += 1
            out["windows"] += len(s.get("windows", ()))
            out["races"] += len(s.get("races", ()))
            out["blocking"] += len(set(s.get("blocking", ())))
        elif s.get("kind") == "machine":
            out["machines"] += 1
            out["sites"] += s.get("sites", 0)
            out["undeclared_transitions"] += len(s.get("undeclared", ()))
            out["dead_edges"] += len(s.get("dead_edges", ()))
            out["protocol"] += len(s.get("protocol", ()))
        out["violations"] += s.get("findings", 0)
    return out
