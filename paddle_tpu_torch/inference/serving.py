"""Continuous-batching serving engine (counterpart of
``paddle_tpu/inference/serving.py``).

Two KV-cache modes, as in the reference.  The dense slot cache
(``paged=False``, the reference's default): one ``max_seq`` lane of K/V a
slot, a request seated whenever a lane is free and prefilled into it, each
decode step writing every lane at its own position and attending it under
the causal mask (``transformer_apply``'s dense attend; its RMSNorms run the
``rms_norm`` kernel); no allocator, so no preemption; with its fault
tolerance, deadlines, ``cancel``, ``max_queue``, ``snapshot`` / ``restore``
and journal as below.  The paged cache (``paged=True``): ``Request``,
``_bucket`` and the path ``serve`` -> ``add_request`` -> ``step`` ->
``_admit`` -> ``_prefill_impl_paged`` -> ``_decode_one`` ->
``_sample_tokens``, with its block allocator (``_alloc_to``,
``_release``), preemption (``_preempt``, ``_ensure_growth``) and
retirement; fp or quantized KV pools (``kv_quant``); the three decode arms
of ``_decode_one``: the fused step (one kernel a layer, fp or quantized
pools), and the unfused arm the ``fused_decode_step`` /
``fused_quant_append`` switches rebuild the engine on (an append, then the
paged decode attention); chunked prefill (``enable_chunked_prefill``:
prompts stream in ``prefill_chunk``-row chunks through one mixed
prefill/decode step a round, ``_mixed_step``) and n-gram speculative
decoding (``enable_speculation``: prompt-lookup drafts checked by one
multi-token verify step, ``_spec_step``), each token-identical to the
bucketed, speculation-off engine; the automatic prefix cache
(``enable_prefix_caching``, ``prefix_cache.py``: shared prompt blocks
mapped read-only, a copy-on-write page for a block-aligned full hit, the
uncached tail prefilled from ``start``, LRU eviction under pool pressure,
blocks donated on retirement and preemption, each streamed chunk's full
blocks registered as it lands); the host KV tier (``enable_host_kv_tier``,
``kv_tier.py``: prefix-cache eviction demotes zero-ref pages to a
byte-budgeted host store instead of freeing them, and admission's prefix
match extends through it, restoring pages by a host to device copy at
admission or at the chunked cursor's pace, with the ``tier_drop`` fault's
seam); and tensor parallelism (``tensor_parallel=N``): N ranks, one
process each on ``torch.distributed``, each run this whole engine over the
same request stream (the scheduler, the allocator, the prefix cache and
the sampler replicated) and hold only their shard: the layer weights split
Megatron-style (``models/llama.shard_serving_params``) and KV pools of
``nkv / N`` kv heads over the whole page axis, so the host allocator's
accounting is exact on every rank and the kernels' page walk never crosses
a rank; each layer pays the reference's two all-reduces (attention output,
MLP output), after which every rank holds the same residual stream and
scores the same full-vocabulary logits, so the replicated samplers agree;
a decision that reads a rank's own clock (a deadline) is agreed by one
small all-reduce, and the caller adds and cancels requests on every rank
between the same two steps.  Each of these options raises ``ValueError``
on the dense engine, with the reference's message.

Both modes: fault tolerance (``PADDLE_TPU_GRACEFUL``, on by default): the
request status lifecycle, the fault plan of ``faults.py``, the NaN/inf
logit guard, retry of an injected dispatch fault, the overload ladder
(paged: evict cache leaves, suspend speculation, shrink the mixed step's
prefill rows, preempt the youngest, fail only the unsatisfiable request),
chunk-by-chunk page mapping of a streaming prompt, deadlines, ``cancel``,
``max_queue`` backpressure and ``snapshot`` / ``restore``; weight-only
quantized matmul weights (``quant``: ``quantize_layer_params`` at
construction, each matmul reading its weight dequantized, the fused MLP
half off as in the reference); observability (``observability.py``):
``stats`` as a view over a metrics registry, request spans, SLO
accounting, the step, host-gap, restore and journal histograms and the
flight recorder, and the reference's ``RecordEvent`` spans
(``profiler.py``) around its transitions (``serving/<status>``, the
ladder's rungs, ``serving/snapshot`` / ``restore``, the prefix cache's and
the tier's moves); the async host runtime (``PADDLE_TPU_ASYNC_HOST``, on
by default): the incremental journal (``journal()``, equal to
``snapshot()``) flushed between a step's last launch and its one host
fetch; the opt-in invariant auditor (``PADDLE_TPU_ENGINE_AUDIT=1``,
``analysis/engine_audit.py``; a dense engine gets I6's bounds and I8)
after admission and after every step, with the KV-write high-water mark
``_written`` it checks.  The engine is also a replica of the fleet router
(``fleet.py``), which reads its ``_reqs``, ``_queue``, ``_pcache``,
``journal()``, ``adopt()`` and ``cancel()``.

How the JAX engine's mechanisms map to PyTorch:

- compiled programs become eager calls: the decode step is a Python loop
  over layers whose per-layer work on the fused arm is two CUDA kernel
  launches (the fused decode step and the fused MLP half) plus the
  rms_norm kernel and plain matmuls; on the dense engine, the reference's
  plain composition (rope, the lane write, the masked attend, the MLP)
  with the rms_norm kernel;
- the donated KV pools become preallocated tensors updated IN PLACE: the
  dense lanes ``[L, max_batch, nkv, max_seq, head_dim]`` in ``cfg.dtype``,
  or the paged pools ``[L, num_blocks + 1, nkv, block_size, head_dim]``
  (quantized: int8 codes ``[..., head_dim]`` or packed int4
  ``[..., head_dim // 2]`` with f32 scales ``[L, num_blocks + 1, nkv]``, a
  ``{"q", "scale"}`` pair per pool as the reference's pytree).  The last
  page is the SPILL page: dropped appends (inactive lanes, positions past
  ``max_seq``) land there, and the allocator never hands it out.  The
  reference grows it on the fused arm only; the port keeps it on every arm
  (every read of it is masked);
- the decode chunk's ``lax.scan`` becomes a loop of ``chunk`` steps whose
  chosen tokens feed back on the device; the host fetches the chunk's
  tokens once per ``step``;
- sampling ports the reference's nucleus (top-p) mask and its keys: each
  sampled token's key is ``fold_in(fold_in(PRNGKey(0), seed), pos)`` and
  its Gumbel noise comes from those keys, as ``jax.random.categorical``
  draws them (``utils/threefry.py``; on the card one kernel,
  ``ops/kernels/sampling.py``), so seeded streams are the JAX
  engine's tokens and a preempted request resumes its stream exactly.
  Greedy streams are the JAX engine's tokens;
- the reference's ``("tp",)`` mesh and ``shard_map`` become one process
  a rank: the step bodies run on the rank's head counts
  (``_TPShardView``) and ``psum`` becomes a sum all-reduce over the
  process group (gloo or NCCL), counted in
  ``models/llama.TP_COUNTERS``;
- JAX's asynchronous dispatch becomes CUDA's: a launch returns at once, so
  the journal's flush (``_host_overlap``), placed between a step's last
  launch and its one host fetch, runs while the card executes the queued
  kernels; the tier's donated page write becomes an in-place ``copy_``
  from page-locked host memory, ordered on the current stream before any
  later kernel reads the page, and its demotion's read blocks until the
  bytes are on the host, before the page returns to the free list.
"""

from __future__ import annotations

import contextlib
import math
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..profiler import RecordEvent
from ..analysis.engine_audit import (EngineAuditError, audit_enabled,
                                     audit_engine)
from ..models import llama as _llama
from ..ops import decode_attention as _da
from ..ops.kernels import kernel_disabled
from ..ops.kernels import paged_attention as _pa
from ..ops.kernels import rope as rope_mod
from ..ops.kernels import sampling
from ..utils.envflags import env_bool, env_tp, tp_problems
from . import (check_params_device, lm_head_logits, quantize_layer_params,
               transformer_apply)
from .faults import FaultInjected, FaultPlan
from .kv_tier import HostKVTier
from .observability import (ENGINE_STAT_SCHEMA, FlightRecorder,
                            MetricsRegistry, RequestTracer, SLOTracker,
                            StatsView, flight_recorder_enabled,
                            metrics_enabled)
from .prefix_cache import PrefixCache
from .speculative import NGramDrafter

__all__ = ["Request", "ContinuousBatchingEngine", "TERMINAL_STATUSES",
           "REQUEST_EDGES", "journal_entry"]

#: terminal request statuses: a request in one of these owns no page and no
#: cache reference
TERMINAL_STATUSES = frozenset({"FINISHED", "FAILED", "REJECTED", "CANCELLED",
                               "EXPIRED"})

#: the request lifecycle's transitions: admission and preemption move
#: between PENDING and RUNNING, either live state may fall to any terminal
#: status, and a terminal status has no way out
REQUEST_EDGES = frozenset(
    {("PENDING", "RUNNING"), ("RUNNING", "PENDING")}
    | {(live, term) for live in ("PENDING", "RUNNING")
       for term in TERMINAL_STATUSES})

#: terminal status -> its counter in ``stats`` (FINISHED counts through the
#: decode counters)
_STATUS_STAT = {"FAILED": "requests_failed", "REJECTED": "requests_rejected",
                "CANCELLED": "requests_cancelled",
                "EXPIRED": "requests_expired"}


@dataclass
class Request:
    rid: int
    prompt_ids: np.ndarray  # [s0] int32
    max_new_tokens: int = 32
    eos_token_id: int | None = None
    # temperature == 0 -> greedy
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int | None = None
    # wall-clock budget from submission: an overdue request ends EXPIRED
    # with the output it has (graceful mode)
    deadline_s: float | None = None
    # filled by the engine
    output_ids: list = field(default_factory=list)
    finished: bool = False
    ttft_s: float | None = None  # submit -> first generated token (wall s)
    # PENDING (queued) -> RUNNING (seated) -> one of TERMINAL_STATUSES;
    # preemption moves a RUNNING request back to PENDING.  ``error`` says
    # why, for every terminal status but FINISHED
    status: str = "PENDING"
    error: str | None = None
    # set at submission when None; a restored request keeps its id
    trace_id: str | None = None


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def journal_entry(req: Request, prefilled: int = 0,
                  now: float | None = None) -> dict:
    """One request's entry in a snapshot: the schema :meth:`~Continuous
    BatchingEngine.snapshot` writes and :meth:`~ContinuousBatchingEngine.
    adopt` reads, the reference's field for field.
    ``deadline_remaining_s`` is the budget left at ``now``: a restore
    re-arms the deadline with it, so a restored request expires at its
    original deadline (``deadline_s`` stays as provenance)."""
    if now is None:
        now = time.perf_counter()
    if req.deadline_s is None:
        remaining = None
    else:
        remaining = max(0.0, float(req.deadline_s)
                        - (now - getattr(req, "_submit_s", now)))
    return {
        "rid": int(req.rid),
        "prompt_ids": np.asarray(req.prompt_ids, np.int32).ravel().tolist(),
        "output_ids": [int(t) for t in req.output_ids],
        "max_new_tokens": int(req.max_new_tokens),
        "eos_token_id": (None if req.eos_token_id is None
                         else int(req.eos_token_id)),
        "temperature": float(req.temperature or 0.0),
        "top_p": float(1.0 if req.top_p is None else req.top_p),
        "seed": None if req.seed is None else int(req.seed),
        "deadline_s": (None if req.deadline_s is None
                       else float(req.deadline_s)),
        "deadline_remaining_s": remaining,
        # the chunk cursor, as provenance: a restore recomputes from the
        # first uncached token
        "prefilled": int(prefilled),
    }


class _TPShardView:
    """One rank's view of the model config under tensor parallelism: the
    step bodies read head counts off the config, and a rank holds nh/tp
    query heads and nkv/tp kv heads of the SAME head_dim, so the view pins
    those counts and the true head_dim (the dataclass property would
    compute it from hidden_size // local heads) and proxies everything
    else (dtype, rope_theta, the layer count, ...) to the real config.
    The GQA ratio nh/nkv does not change with the degree, so the
    paged-attention kernels take the rank's shapes as they are."""

    def __init__(self, cfg, tp: int):
        self._cfg = cfg
        self.num_attention_heads = cfg.num_attention_heads // tp
        self.num_key_value_heads = cfg.num_key_value_heads // tp
        self.head_dim = cfg.head_dim

    def __getattr__(self, name):
        return getattr(self._cfg, name)


_TP_NEEDS_PAGED = ("tensor_parallel > 1 requires paged=True (TP shards the "
                   "paged KV pool along kv_heads)")


def _resolve_tp(cfg, tensor_parallel: int, group, paged: bool) -> int:
    """The engine's tensor-parallel degree, as the reference resolves it:
    ``PADDLE_TPU_TP`` replaces the constructor's value (an invalid one
    warns and gives 1, ``env_tp``, and so does any degree above 1 on the
    dense engine); a constructor value that ``tp_problems`` refuses (a
    degree above 1 needs the paged engine, must divide the kv heads and
    ``intermediate_size`` and equal the size of an initialized process
    group: ``group``, or the default one) raises ``ValueError`` naming
    every problem."""
    nkv, inter = cfg.num_key_value_heads, cfg.intermediate_size
    ready = dist.is_available() and dist.is_initialized()
    ranks = dist.get_world_size(group) if ready else None
    tp_env = env_tp(nkv, ranks, inter)
    if tp_env is not None:
        if tp_env > 1 and not paged:
            # the operator's override degrades, never crashes the serve
            warnings.warn(f"PADDLE_TPU_TP={tp_env}: {_TP_NEEDS_PAGED}; "
                          f"falling back to tensor_parallel=1")
            return 1
        return tp_env           # the operator's override replaces the value
    tp = int(tensor_parallel)
    problems = tp_problems(tp, nkv, inter, ranks)
    if tp > 1 and not paged:
        problems.insert(0, _TP_NEEDS_PAGED)
    if problems:
        raise ValueError(f"tensor_parallel={tp}: " + "; ".join(problems))
    return tp


def _tree_to(tree, device):
    """Every tensor of a nested dict on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class ContinuousBatchingEngine:
    """Slot-pool continuous batching over a Llama-family model.

    ``cfg``/``params`` follow ``paddle_tpu_torch.models.llama`` (the
    reference's layout; ``utils/convert.py`` bridges a JAX parameter tree).
    ``device`` defaults to the CUDA card and must hold ``params``.
    ``paged`` (default False, as in the reference): False gives the dense
    slot cache, one ``max_seq`` lane a slot; True the block-table cache
    (``block_size`` positions a page, ``num_blocks`` pages, by default half
    the dense cache's capacity, at least one full request), which
    ``kv_quant``, ``enable_prefix_caching``, ``enable_host_kv_tier``,
    ``enable_speculation``, ``enable_chunked_prefill`` and
    ``tensor_parallel > 1`` need (the dense engine raises ``ValueError``
    for each, with the reference's message).
    ``block_size`` / ``num_blocks`` are read by the paged engine only.
    ``kv_quant``: None | 'int8' | 'int4' -- quantized KV pools (paged
    only): pages hold int8 codes
    (int4 packs two a byte) with per-(page, kv head) f32 scales; every
    attention read dequantizes, every append requantizes its page.
    ``enable_speculation``: prompt-lookup n-gram drafting (``spec_ngram``
    the longest suffix matched, up to ``num_draft_tokens`` = K drafts a
    slot) checked by one verify step of K+1 rows a slot; the accepted
    stream is token-identical to the speculation-off engine.  Kill switch
    ``PADDLE_TPU_SPECULATE=0``.
    ``enable_chunked_prefill``: prompts stream in ``prefill_chunk``-row
    chunks co-scheduled with decode in one mixed step a round (decode rows
    pack first, prefill chunks fill ``token_budget``, default
    ``prefill_chunk + max_batch``, with a one-row floor), so decode never
    stalls behind a prompt.  Kill switch ``PADDLE_TPU_CHUNKED_PREFILL=0``.
    ``enable_prefix_caching``: content-addressed reuse of full KV blocks
    across requests (``prefix_cache.py``); the engine never writes a shared
    page.  Kill switch ``PADDLE_TPU_PREFIX_CACHE=0``.
    ``max_queue``: admission backpressure; with that many requests waiting,
    ``add_request`` ends a newcomer REJECTED (graceful mode) or raises.
    Preemption re-inserts and restored requests are exempt.
    ``PADDLE_TPU_GRACEFUL`` (default on): a fault ends the one request it
    touches (FAILED, EXPIRED, CANCELLED, REJECTED, with ``error``) and the
    overload ladder degrades before anyone fails; ``0`` gives the engine
    that raises out of ``step``.  ``PADDLE_TPU_FAULT_INJECT`` is the fault
    plan (``faults.py``).
    ``quant``: None | 'int8' | 'int4' -- weight-only quantized layer matmul
    weights (``quantize_layer_params``, at construction; embed, lm_head and
    the norms stay fp), each dequantized into the model dtype where a
    matmul reads it.  The fused MLP half is off under ``quant``, as in the
    reference (it would stream dense weights); the fused decode step stays.
    ``metrics`` / ``metrics_labels``: a shared
    :class:`~.observability.MetricsRegistry` and a constant label set
    (e.g. ``{"replica": k}``); by default the engine makes its own
    registry.  ``PADDLE_TPU_METRICS=0`` restores the plain ``stats`` dict,
    with no registry, spans or SLO tracking; ``PADDLE_TPU_FLIGHT_RECORDER
    =0`` turns the flight recorder off.
    ``enable_host_kv_tier`` (needs ``enable_prefix_caching``): the host KV
    tier (``kv_tier.py``): eviction demotes zero-ref cached pages to a
    byte-budgeted host store (``PADDLE_TPU_HOST_TIER_MIB``) instead of
    freeing them, and admission's prefix match extends through it, a tier
    hit restoring pages by a host to device copy where prefill would
    compute them (tokens identical).  ``host_tier``: a
    :class:`~.kv_tier.HostKVTier` built by the caller (a shared one).
    Kill switch ``PADDLE_TPU_HOST_KV_TIER=0``; ``PADDLE_TPU_PREFIX_CACHE=0``
    turns the tier off too.
    ``PADDLE_TPU_ASYNC_HOST`` (default on): the journal (:meth:`journal`)
    is kept incrementally and flushed while the card runs each step; ``0``
    leaves every flush to :meth:`journal` itself.
    ``tensor_parallel``: the number of ranks sharing the model, each a
    process of ``process_group`` (None: the default group) that builds
    this engine with the same arguments and serves the same requests.  It
    must divide ``num_key_value_heads`` and ``intermediate_size`` and
    equal the group's size, or the constructor raises.  ``params`` is the
    full tree, on any device (the host keeps it off the card): quantized
    whole under ``quant``, then sliced, only the rank's slice reaching
    ``device``.  ``PADDLE_TPU_TP`` replaces the value (an invalid one warns
    and serves on one card).  The ranks' schedulers stay in step only if
    each takes the same decisions at the same step: ``add_request`` and
    :meth:`cancel` must be called on every rank between the same two
    steps; deadlines are agreed by one small all-reduce (a request expires
    at the first step any rank's clock finds it overdue).  The snapshot
    records the degree, and a restore takes a snapshot of any degree.
    """

    def __init__(self, cfg, params, max_batch: int = 8, max_seq: int = 512,
                 chunk: int = 1, quant: str | None = None, paged: bool = False,
                 kv_quant: str | None = None, block_size: int = 64,
                 num_blocks: int | None = None,
                 enable_prefix_caching: bool = False,
                 enable_speculation: bool = False, num_draft_tokens: int = 4,
                 spec_ngram: int = 3, enable_chunked_prefill: bool = False,
                 prefill_chunk: int = 128, token_budget: int | None = None,
                 max_queue: int | None = None, tensor_parallel: int = 1,
                 enable_host_kv_tier: bool = False, host_tier=None,
                 metrics=None, metrics_labels: dict | None = None,
                 process_group=None, device=None):
        self.device = resolve_device(device)
        self.paged = bool(paged)
        L = cfg.num_hidden_layers
        hd = cfg.head_dim
        # quantized KV pools, validated before any geometry, as the
        # reference validates them
        if kv_quant is not None:
            if kv_quant not in ("int8", "int4"):
                raise ValueError(f"kv_quant must be None, 'int8' or "
                                 f"'int4', got {kv_quant!r}")
            if not paged:
                raise ValueError("kv_quant requires paged=True (per-page "
                                 "scales live on block-table pages)")
            if kv_quant == "int4" and hd % 2:
                raise ValueError(f"kv_quant='int4' needs an even head_dim "
                                 f"(got {hd}): two nibbles pack per byte")
        self.kv_quant = kv_quant
        # tensor parallelism, resolved before the pools: they are built
        # sharded.  tp == 1 is the single-card engine exactly (no group, no
        # collective): every TP behaviour hangs off self.tp > 1
        self.tp = _resolve_tp(cfg, tensor_parallel, process_group, paged)
        self._tp_group = None
        self._tp_rank = 0
        self._body_cfg = cfg        # the config the step bodies read
        if self.tp > 1:
            self._tp_group = (process_group if process_group is not None
                              else dist.group.WORLD)
            self._tp_rank = dist.get_rank(self._tp_group)
            self._body_cfg = _TPShardView(cfg, self.tp)
            params = self._rank_params(cfg, params, quant)
        else:
            check_params_device(params, self.device)
            if quant is not None:
                params = quantize_layer_params(params, quant)
        self.quant = quant
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.chunk = int(chunk)
        # a rank's pools hold its kv heads over the WHOLE page axis
        nkv = self._body_cfg.num_key_value_heads
        # the fused decode step and the fused MLP half ride the paged
        # engine only, as in the reference
        self._fused = self._fused_mlp = False
        if not paged:
            # the dense slot cache: one max_seq lane a slot, no allocator;
            # the block geometry is the paged engine's only
            self.block_size = self.max_blocks = self.num_blocks = None
            shape = (L, max_batch, nkv, max_seq, hd)
            self.cache_k = torch.zeros(shape, dtype=cfg.dtype,
                                       device=self.device)
            self.cache_v = torch.zeros(shape, dtype=cfg.dtype,
                                       device=self.device)
        else:
            self._init_paged(cfg, max_batch, max_seq, block_size, num_blocks,
                             quant)
        cos, sin = rope_mod.rope_cos_sin(max_seq, hd, base=cfg.rope_theta,
                                         dtype=cfg.dtype, device=self.device)
        self._cos, self._sin = cos, sin             # [1, max_seq, hd]
        # slot state (host side)
        self._slot_req: list[Request | None] = [None] * max_batch
        self._pos = np.zeros(max_batch, np.int32)      # next write position
        # KV-write high-water mark a slot: positions [0, _written) hold K/V
        # the device wrote (or the cache mapped).  Equal to pos but after a
        # verify step with rejections, whose rolled-back drafts' writes stay
        # above pos until overwritten; the auditor's I6 checks pos <=
        # written <= the mapped pages' coverage
        self._written = np.zeros(max_batch, np.int32)
        self._last_tok = np.zeros(max_batch, np.int32)
        self._temp = np.zeros(max_batch, np.float32)
        self._topp = np.ones(max_batch, np.float32)
        self._seed = np.zeros(max_batch, np.int32)
        self._queue: list[Request] = []
        # prefix cache, speculation and chunked prefill: every behaviour of
        # each hangs off self._pcache / self._spec / self._chunked, and the
        # kill switch is read FIRST, so =0 turns the feature off whatever
        # the arguments say
        self._pcache = None
        if enable_prefix_caching and env_bool("PADDLE_TPU_PREFIX_CACHE",
                                              True):
            if not paged:
                raise ValueError("enable_prefix_caching requires paged=True "
                                 "(the cache shares block-table pages)")
            self._pcache = PrefixCache(block_size)
        # the host KV tier behind the prefix cache: every behaviour hangs
        # off self._tier, and the kill switch is read FIRST, so =0 leaves
        # the pre-tier engine (eviction frees, admission stops at the
        # device match)
        self._tier = None
        if ((enable_host_kv_tier or host_tier is not None)
                and env_bool("PADDLE_TPU_HOST_KV_TIER", True)):
            if not paged or not enable_prefix_caching:
                raise ValueError(
                    "enable_host_kv_tier requires paged=True and "
                    "enable_prefix_caching=True (the tier is keyed by the "
                    "prefix cache's chain hashes and holds its evicted "
                    "pages)")
            if self._pcache is not None:
                # PADDLE_TPU_PREFIX_CACHE=0 turns the tier off too: with no
                # content address there is nothing to demote or match
                self._tier = (host_tier if host_tier is not None
                              else HostKVTier())
                # per-slot restore plans [(block, hash, parent), ...],
                # consumed front first by the chunked cursor at the token
                # budget's pace and dropped whole on preempt, cancel,
                # terminal or a tier miss
                self._tier_plan: list[list] = [[] for _ in range(max_batch)]
        # fault tolerance: graceful is decided here; off, the steps run no
        # guard, and faults raise out of step()
        self._graceful = env_bool("PADDLE_TPU_GRACEFUL", True)
        self._faults = FaultPlan.from_env()
        self._step_no = 0              # engine step counter (fault-plan key)
        self.max_queue = max_queue
        # rid -> every live accepted request (cancel's lookup)
        self._reqs: dict[int, Request] = {}
        # per-slot poison bits of the nan_logits fault: a graceful step on
        # which one is set turns it into a non-finite logits row on the
        # device
        self._poison = np.zeros(max_batch, bool)
        self._kernel_err_streak = 0
        # consecutive injected dispatch faults retried before re-raising
        self._kernel_err_limit = 3
        # consecutive steps in which admission seated nothing with nothing
        # resident (ladder rung 5 at admission after this many)
        self._admit_stalls = 0
        self._spec = None
        self._spec_qmax = 0            # the verify step's rows a slot, K+1
        if enable_speculation and env_bool("PADDLE_TPU_SPECULATE", True):
            if not paged:
                raise ValueError(
                    "enable_speculation requires paged=True (the multi-token "
                    "verify step runs through the paged-attention kernel)")
            self._spec = NGramDrafter(num_draft_tokens=num_draft_tokens,
                                      max_ngram=spec_ngram)
            self._spec_qmax = int(num_draft_tokens) + 1
        self._chunked = False
        if enable_chunked_prefill and env_bool("PADDLE_TPU_CHUNKED_PREFILL",
                                               True):
            if not paged:
                raise ValueError(
                    "enable_chunked_prefill requires paged=True (prefill "
                    "chunks stream into block-table pages)")
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}")
            self._chunked = True
            self._prefill_chunk = int(prefill_chunk)
            self._token_budget = (int(token_budget)
                                  if token_budget is not None
                                  else self._prefill_chunk + max_batch)
            # per-slot prefill progress: the FULL id stream (prompt, or
            # prompt + generated on a resume) while the slot streams in,
            # and the cursor, the next position whose K/V is computed
            self._prefill_ids: list[np.ndarray | None] = [None] * max_batch
            self._prefilled = np.zeros(max_batch, np.int32)
            # the last mixed step's (decode slots, prefill slots): the
            # auditor's I7 checks the two stayed disjoint
            self._last_pack: tuple[tuple[int, ...], tuple[int, ...]] = \
                ((), ())
        # wall seconds of the bucketed prefills (synchronized): the port's
        # own figure, kept beside ``stats`` (whose keys are the schema's)
        self.prefill_time_s = 0.0
        self._setup_observability(metrics, metrics_labels)
        # the opt-in invariant auditor (PADDLE_TPU_ENGINE_AUDIT=1): the
        # allocator, block tables, prefix cache and tier checked against
        # each other after admission and after every step, raising
        # EngineAuditError on corruption (analysis/engine_audit.py); off,
        # the step reads this one flag
        self._audit_every_step = audit_enabled()
        # the async host runtime: the journal mirrors what snapshot() would
        # write for each live rid, rebuilt only for the rids marked dirty
        # (admission, a token banked, a cursor advance, adopt, preempt).
        # The marks are unconditional; the switch only decides whether the
        # flush rides each step's launch window, so =0 leaves the serial
        # loop as it was
        self._async_host = env_bool("PADDLE_TPU_ASYNC_HOST", True)
        self._jentries: dict[int, dict] = {}
        self._jdirty: set[int] = set()
        #: logits [B, V] of the last step run (inspection only): a decode
        #: step's, a mixed step's emit rows, a verify step's row 0
        self.last_logits: torch.Tensor | None = None

    def _init_paged(self, cfg, max_batch, max_seq, block_size, num_blocks,
                    quant):
        """The paged engine's pools and host allocator.  The pools are
        ``[L, num_blocks + 1, nkv, block_size, head_dim]`` (quantized:
        codes and per-(page, kv head) scales); the last page is the spill
        page, which the allocator never hands out."""
        if max_seq % block_size:
            raise ValueError(f"max_seq {max_seq} is not a multiple of "
                             f"block_size {block_size}")
        self.block_size = block_size
        self.max_blocks = max_seq // block_size     # per-slot logical cap
        # default pool: half the worst-case footprint, floored at ONE full
        # request
        self.num_blocks = (num_blocks if num_blocks is not None
                           else max((max_batch * self.max_blocks) // 2,
                                    self.max_blocks))
        if self.num_blocks < self.max_blocks:
            raise ValueError(f"pool of {self.num_blocks} blocks cannot hold "
                             f"one full request ({self.max_blocks} blocks)")
        L = cfg.num_hidden_layers
        nkv, hd = self._body_cfg.num_key_value_heads, cfg.head_dim
        kv_quant = self.kv_quant
        # the decode arm, decided here as the reference decides it: the
        # fused step unless a switch rebuilds the engine on the unfused arm
        # (an append, then the paged decode attention, which still runs its
        # kernels).  The fused MLP half rides the fused arm only, and only
        # over fp matmul leaves: under ``quant`` the MLP reads its weights
        # through the dequantize, as in the reference
        self._fused = not (kernel_disabled("paged_attention")
                           or kernel_disabled("fused_decode_step")
                           or (kv_quant is not None
                               and kernel_disabled("fused_quant_append")))
        self._fused_mlp = (self._fused and quant is None
                           and not kernel_disabled("fused_layer_mlp"))
        nbp = self.num_blocks + 1                   # + the spill page
        if kv_quant is None:
            shape = (L, nbp, nkv, block_size, hd)
            self.cache_k = torch.zeros(shape, dtype=cfg.dtype,
                                       device=self.device)
            self.cache_v = torch.zeros(shape, dtype=cfg.dtype,
                                       device=self.device)
        else:
            hd_store = hd // 2 if kv_quant == "int4" else hd
            shape = (L, nbp, nkv, block_size, hd_store)
            self.cache_k, self.cache_v = (
                {"q": torch.zeros(shape, dtype=torch.int8, device=self.device),
                 "scale": torch.zeros(shape[:3], dtype=torch.float32,
                                      device=self.device)}
                for _ in range(2))
        # host allocator state; sentinel num_blocks = unallocated (it
        # resolves to the spill page, whose reads are always masked)
        self._free: list[int] = list(range(self.num_blocks))
        self._slot_blocks: list[list[int]] = [[] for _ in range(max_batch)]
        # shared (refcounted, read-only) cached blocks at the FRONT of each
        # slot's row, its private pages after them: [shared..., private...]
        self._slot_shared: list[list[str]] = [[] for _ in range(max_batch)]
        self._table = np.full((max_batch, self.max_blocks), self.num_blocks,
                              np.int32)
        self._admit_seq = 0
        self._slot_age = np.zeros(max_batch, np.int64)

    def _rank_params(self, cfg, params, quant):
        """This rank's slice of the full tree ``params`` on the engine's
        device: quantized whole (``quant``: a row-parallel leaf's scales
        are an absmax over its whole input dim), then sliced
        (``shard_serving_params``)."""
        want = _llama.serving_matmul_shapes(cfg)
        have = {n: tuple(params["layers"][n].shape) for n in want}
        if have != want:
            raise ValueError(f"params must be the full tree {want}: {have}")
        if quant is not None:
            params = quantize_layer_params(params, quant)
        return _tree_to(_llama.shard_serving_params(
            cfg, params, self._tp_rank, self.tp, quant), self.device)

    def _setup_observability(self, metrics, labels):
        """``stats`` over a metrics registry (keys and help strings:
        ``ENGINE_STAT_SCHEMA``), the SLO tracker, the request tracer, the
        step and host-gap histograms and the flight recorder, as the
        reference sets them up.  Everything records on the host, before a
        step's launches or after its fetch."""
        self._obs_labels = dict(labels or {})
        replica = self._obs_labels.get("replica")
        obs_name = f"replica-{replica}" if replica is not None else "engine"
        if metrics_enabled():
            self.metrics = (metrics if metrics is not None
                            else MetricsRegistry())
            self.stats = StatsView(self.metrics, ENGINE_STAT_SCHEMA,
                                   self._obs_labels)
            self.slo = SLOTracker(self.metrics, self._obs_labels)
            self._h_hostgap = self.metrics.histogram(
                "paddle_tpu_serving_host_gap_seconds",
                "Host-side gap between the end of one compiled serving "
                "step and the next launch (scheduler/drafter/router time "
                "the device sits idle — ROADMAP item 5's target)"
            ).labels(**self._obs_labels)
            self._h_step = self.metrics.histogram(
                "paddle_tpu_serving_step_seconds",
                "Wall seconds per compiled serving step (launch to host "
                "fetch)").labels(**self._obs_labels)
            self._h_h2d = (self.metrics.histogram(
                "paddle_tpu_serving_h2d_restore_seconds",
                "Host->device dispatch seconds per tier page restore "
                "(kv_tier ship_in: two donated pool writes, overlapped "
                "with the next compiled step by async dispatch)")
                .labels(**self._obs_labels) if self._tier is not None
                else None)
            self._h_jupdate = self.metrics.histogram(
                "paddle_tpu_serving_journal_update_seconds",
                "Host seconds per incremental journal flush (dirty-rid "
                "entry rebuilds overlapped with the in-flight device "
                "step, docs/async_runtime.md)").labels(**self._obs_labels)
            self._tracer = RequestTracer(
                enabled=True, pid=int(replica) if replica is not None else 0,
                process_name=obs_name)
        else:
            self.metrics = None
            self.slo = None
            self._h_hostgap = self._h_step = self._h_h2d = None
            self._h_jupdate = None
            self._tracer = RequestTracer(enabled=False)
            self.stats = {k: (0.0 if kind == "gauge" else 0)
                          for k, (kind, _) in ENGINE_STAT_SCHEMA.items()}
        self._last_step_end = None      # the host-gap histogram's anchor
        self._flight = (FlightRecorder(registry=self.metrics, name=obs_name)
                        if flight_recorder_enabled() else None)

    def _note_launch(self, t0: float):
        """At a step's launch: the gap since the previous step's fetch is
        host work the device sat idle through."""
        if self._h_hostgap is not None and self._last_step_end is not None:
            self._h_hostgap.observe(t0 - self._last_step_end)

    def _note_step_done(self, t0: float):
        """After a step's one host fetch: its wall, launch to fetch."""
        end = time.perf_counter()
        if self._h_step is not None:
            self._h_step.observe(end - t0)
        self._last_step_end = end

    def _record(self, kind: str, **detail):
        """One flight-recorder event (nothing when the recorder is off)."""
        if self._flight is not None:
            self._flight.record(kind, **detail)

    def _maybe_audit(self):
        """With the auditor on, check the engine's invariants; a violation
        dumps the flight recorder (its recent events and a metrics
        snapshot) and raises."""
        if not self._audit_every_step:
            return
        try:
            audit_engine(self)
        except EngineAuditError:
            if self._flight is not None:
                self._flight.dump("engine_audit_error")
            raise

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------- decode step ----------------

    def _decode_one(self, tokens, pos, active, table):
        """One batched decode step: tokens/pos [B] int64, active [B] bool,
        table [B, max_blocks] int32 or None on the dense engine (all on the
        device) -> logits [B, V].  Dense: each lane writes its K/V at its
        own position of its slot lane (inactive lanes and positions past
        max_seq write their old value back) and attends the lane under the
        causal mask, ``transformer_apply``'s dense attend.  Paged, on the
        fused arm, rope + the page append (requantizing for quantized
        pools) + split-K attention run as ONE kernel launch per layer and
        the post-attention half as another; the unfused arm ropes, appends
        (a row scatter, or the requantized page append) and attends through
        ``paged_decode_attention``.  Dropped writes land on the spill page
        or nowhere; inactive lanes compute garbage that is never read."""
        cfg = self._body_cfg    # TP: the rank's head counts
        B, S, bs = self.max_batch, self.max_seq, self.block_size
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        kvq = self.kv_quant
        x = self.params["embed"][tokens][:, None].to(cfg.dtype)   # [B, 1, h]
        writeable = active & (pos < S)
        safe_pos = torch.where(writeable, pos, torch.zeros_like(pos))
        cos = self._cos[0][safe_pos]                              # [B, hd]
        sin = self._sin[0][safe_pos]
        if table is None:
            return self._decode_dense(x, pos, active, writeable, safe_pos,
                                      cos, sin)
        lane = torch.arange(B, device=self.device)
        blk = table[lane, safe_pos // bs].long()
        spill = self.num_blocks
        wblk = torch.where(writeable, blk.clamp(max=spill),
                           torch.full_like(blk, spill))
        write = attend_fn = fused_fn = mlp_fused_fn = None

        if self._fused:
            lens_pre = safe_pos.int()   # append position; inactive lanes 0
            wblk_i, wable = wblk.int(), writeable.int()

            def fused_fn(q, k, v, ck, cv):
                # q [B, 1, nh, hd] / k, v [B, 1, nkv, hd] PRE-rope
                if kvq is None:
                    o, _, _ = _da.fused_paged_decode_step(
                        q[:, 0], k[:, 0], v[:, 0], cos, sin, ck, cv, table,
                        lens_pre, wblk_i, wable)
                else:
                    o, *_ = _da.fused_paged_quant_decode_step(
                        q[:, 0], k[:, 0], v[:, 0], cos, sin, ck["q"],
                        ck["scale"], cv["q"], cv["scale"], table, lens_pre,
                        wblk_i, wable, kvq)
                return o.reshape(B, 1, nh * hd), ck, cv
        else:
            off = safe_pos % bs
            seq_now = (safe_pos + 1).int()  # incl. the token written now

            def write(ck, k):
                # k [B, 1, nkv, hd] roped.  Dropped lanes target the spill
                # page and write its own bytes back
                if kvq is not None:
                    _pa.quant_append_decode(ck["q"], ck["scale"], k[:, 0],
                                            wblk, off, writeable, kvq)
                    return ck, ck
                old = ck[wblk, :, off]
                ck[wblk, :, off] = torch.where(writeable[:, None, None],
                                               k[:, 0].to(ck.dtype), old)
                return ck, ck

            def attend_fn(q, k_pool, v_pool):
                # q [B, 1, nh, hd] roped; sentinel table entries clamp to
                # the spill page and are masked by seq_now
                if kvq is None:
                    o = _da.paged_decode_attention(q[:, 0], k_pool, v_pool,
                                                   table, seq_now)
                else:
                    o = _da.paged_decode_attention(
                        q[:, 0], k_pool["q"], v_pool["q"], table, seq_now,
                        kv_quant=kvq, k_scale=k_pool["scale"],
                        v_scale=v_pool["scale"])
                return o.reshape(B, 1, nh * hd)

        if self._fused_mlp:
            def mlp_fused_fn(h_res, attn_y, lp):
                h1, y = _pa.fused_layer_mlp(h_res[:, 0], attn_y[:, 0],
                                            lp["post_norm"], lp["w_gate"],
                                            lp["w_up"], lp["w_down"],
                                            cfg.rms_norm_eps)
                return h1[:, None], y[:, None]

        x, _, _ = transformer_apply(cfg, self.params, x, self.cache_k,
                                    self.cache_v, write, None, cos[:, None],
                                    sin[:, None], attend_fn=attend_fn,
                                    fused_fn=fused_fn,
                                    mlp_fused_fn=mlp_fused_fn,
                                    quant=self.quant, tp_group=self._tp_group)
        return lm_head_logits(cfg, self.params, x[:, -1])

    def _decode_dense(self, x, pos, active, writeable, safe_pos, cos, sin):
        """``_decode_one`` on the dense slot cache: the reference's dense
        decode (no hand kernel on this arm but the RMSNorms')."""
        cfg = self.cfg
        lane = torch.arange(self.max_batch, device=self.device)
        kv_pos = torch.arange(self.max_seq, device=self.device)
        mask = ((kv_pos[None, None, None, None, :]
                 <= pos[:, None, None, None, None])
                & active[:, None, None, None, None])

        def write(ck, k):
            # ck [B, nkv, S, hd] a layer's lanes; k [B, 1, nkv, hd] roped:
            # each lane at its own position, dropped lanes keep their value
            old = ck[lane, :, safe_pos]
            ck[lane, :, safe_pos] = torch.where(writeable[:, None, None],
                                                k[:, 0].to(ck.dtype), old)
            return ck, ck

        x, _, _ = transformer_apply(cfg, self.params, x, self.cache_k,
                                    self.cache_v, write, mask, cos[:, None],
                                    sin[:, None], quant=self.quant)
        return lm_head_logits(cfg, self.params, x[:, -1])

    def _sample_tokens(self, logits, pos, temp, topp, seeds, rows):
        """Per-slot next token: greedy where temperature == 0, temperature +
        nucleus (top-p) sampling elsewhere.  ``pos``/``seeds`` are [B]
        device ints; a lane's draw is keyed by (seed, position) exactly as
        the reference keys it, so sampling is replayable and matches the
        reference's tokens.  ``rows`` holds the lanes with temperature > 0
        (None: no draw at all); only their rows are sorted and drawn.
        Nothing here waits for the device."""
        greedy = logits.argmax(dim=-1)
        if rows is None:
            return greedy
        scaled = logits[rows].float() / temp[rows].clamp(min=1e-6)[:, None]
        # nucleus mask via sorted cumsum: keep the smallest prefix of
        # descending-prob tokens whose mass reaches top_p (top-1 always kept)
        order = torch.argsort(-scaled, dim=-1, stable=True)
        sprob = torch.softmax(torch.gather(scaled, 1, order), dim=-1)
        keep_sorted = ((torch.cumsum(sprob, dim=-1) - sprob)
                       < topp[rows][:, None])
        keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
        masked = torch.where(keep, scaled,
                             torch.full_like(scaled, float("-inf")))
        # jax.random.categorical: argmax(gumbel(key) + logits), one
        # vectorized draw for the sampled rows
        noise = sampling.gumbel_noise(seeds[rows], pos[rows], scaled.shape[1])
        return greedy.index_put((rows,), (noise + masked).argmax(dim=-1))

    @staticmethod
    def _guard_logits(logits, active, poison=None, live=None):
        """The NaN/inf logit guard of the graceful steps, on the device:
        the ``nan_logits`` poison bits (given only on a step a clause armed)
        go in FIRST, as a genuinely NaN row, so injection meets the same
        finiteness check a real blow-up does; then every ACTIVE slot whose
        logits are not finite is flagged and its rows zeroed, so the sampler
        stays finite (the host discards the flagged slot's tokens and fails
        its request).  Inactive lanes are left out: their garbage rows may
        be non-finite.  logits [B, V], or [B, Q, V] with ``live`` [B, Q] the
        rows that count; active and poison [B] -> (logits, bad [B])."""
        shape = (-1,) + (1,) * (logits.dim() - 1)
        if poison is not None:
            row = torch.where(poison, float("nan"), 0.0).to(logits.dtype)
            logits = logits + row.view(shape)
        fin = torch.isfinite(logits).all(dim=-1)
        if live is not None:
            fin = (fin | ~live).all(dim=-1)
        bad = active & ~fin
        return torch.where(bad.view(shape), 0.0, logits), bad

    def _chunk_scan(self, tokens, pos, active, temp, topp, table, seeds,
                    rows, guard=False, poison=None):
        """``chunk`` decode steps; the chosen token feeds back on the
        device.  Returns (tokens [chunk, B], bad [chunk, B]): with ``guard``
        (graceful mode) ``bad`` holds the guard's flags of each step, else
        it is None and no guard runs; ``poison`` [B] as in
        ``_guard_logits``."""
        toks, bads = [], []
        tok = tokens
        for i in range(self.chunk):
            logits = self._decode_one(tok, pos + i, active, table)
            if guard:
                logits, bad = self._guard_logits(logits, active, poison)
                bads.append(bad)
            tok = self._sample_tokens(logits, pos + i, temp, topp, seeds,
                                      rows)
            toks.append(tok)
        self.last_logits = logits
        return torch.stack(toks), (torch.stack(bads) if bads else None)

    # ---------------- multi-row steps: mixed prefill/decode, verify --------

    def _rows_forward(self, tokens, pos, active, q_lens, table, verify):
        """The multi-row forward of the mixed and the verify step: tokens
        [B, T] (row t of slot b = the token at position pos[b] + t), pos [B]
        row-0 positions, active [B] bool, q_lens [B] live rows, table [B,
        max_blocks] int32 (all on the device) -> final-normed hidden [B, T,
        h].  Every live row's K/V goes into its page at pos + t; rows at or
        past q_lens, inactive lanes and positions past max_seq land on the
        spill page (fp pools) or drop out of the requantized event.
        Attention is ONE ragged paged walk a layer under the per-row causal
        law: the verify walk over fp pools when ``verify``, else (and over
        quantized pools, which only the prefill walk dequantizes, as in the
        reference) the chunked-prefill walk."""
        cfg = self._body_cfg    # TP: the rank's head counts
        B, S, bs = self.max_batch, self.max_seq, self.block_size
        T = tokens.shape[1]
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        kvq = self.kv_quant
        rows = torch.arange(T, device=self.device)[None, :]
        x = self.params["embed"][tokens].to(cfg.dtype)           # [B, T, h]
        pos_t = pos[:, None] + rows                               # [B, T]
        valid_t = active[:, None] & (rows < q_lens[:, None]) & (pos_t < S)
        safe_t = torch.where(valid_t, pos_t, torch.zeros_like(pos_t))
        cos = self._cos[0][safe_t]                                # [B, T, hd]
        sin = self._sin[0][safe_t]
        if kvq is not None:
            write = self._quant_rows_write(table, pos_t, valid_t, view=False)
        else:
            lane = torch.arange(B, device=self.device)[:, None]
            spill = self.num_blocks
            blk = table[lane, safe_t // bs].long().clamp(max=spill)
            wblk = torch.where(valid_t, blk, torch.full_like(blk, spill))
            off = safe_t % bs

            def write(ck, k):
                # k [B, T, nkv, hd] roped.  Distinct slots own disjoint
                # pages and distinct rows distinct positions: live writes
                # never collide
                ck[wblk, :, off] = k.to(ck.dtype)
                return ck, ck
        # total written length incl. the rows; an inactive lane attends one
        # stale position (finite, never read)
        seq_base = torch.where(active & (pos < S), pos, torch.zeros_like(pos))
        seq_now = (seq_base + torch.where(active, q_lens,
                                          torch.ones_like(q_lens))) \
            .clamp(max=S).int()
        ql = q_lens.int()

        def attend_fn(q, k_pool, v_pool):
            # q [B, T, nh, hd] roped
            if kvq is not None:
                o = _da.paged_prefill_attention(
                    q, k_pool["q"], v_pool["q"], table, seq_now, ql,
                    kv_quant=kvq, k_scale=k_pool["scale"],
                    v_scale=v_pool["scale"])
            elif verify:
                o = _da.paged_verify_attention(q, k_pool, v_pool, table,
                                               seq_now, ql)
            else:
                o = _da.paged_prefill_attention(q, k_pool, v_pool, table,
                                                seq_now, ql)
            return o.reshape(B, T, nh * hd)

        x, _, _ = transformer_apply(cfg, self.params, x, self.cache_k,
                                    self.cache_v, write, None, cos, sin,
                                    attend_fn=attend_fn, quant=self.quant,
                                    tp_group=self._tp_group)
        return x

    def _mixed_impl(self, tokens, pos, active, q_lens, temp, topp, seeds,
                    table, rows, guard=False, poison=None):
        """One mixed prefill/decode step: decode-ready slots ride as
        ``q_lens == 1`` lanes, prefilling slots carry a chunk of their
        prompt.  ONLY each slot's last live row goes through the lm_head;
        its token is drawn with the (seed, pos + q_lens - 1) key the plain
        decode step uses at that position, so a decode lane's token and a
        completing prefill's first token are the bucketed engine's.
        Returns (next token [B], bad [B]: with ``guard`` the guard's flags
        of the emit rows, else None)."""
        B = self.max_batch
        x = self._rows_forward(tokens, pos, active, q_lens, table,
                               verify=False)
        last = x[torch.arange(B, device=self.device), q_lens - 1]
        logits = lm_head_logits(self.cfg, self.params, last)      # [B, V]
        bad = None
        if guard:
            logits, bad = self._guard_logits(logits, active, poison)
        self.last_logits = logits
        nxt = self._sample_tokens(logits, pos + q_lens - 1, temp, topp,
                                  seeds, rows)
        return nxt, bad

    def _verify_impl(self, tokens, pos, active, q_lens, temp, topp, seeds,
                     table, rows, guard=False, poison=None):
        """Verify + accept in one step.  tokens [B, Q]: row 0 the pending
        token, rows 1.. the drafts.  Row t's token is drawn with the key
        (seed, pos + t) the plain decode step would use there, so row 0's
        token is what plain decode produces and a draft is accepted exactly
        when it equals the token chosen one row earlier: the accepted
        stream is token-identical to the speculation-off engine.  ``rows``
        are the sampled lanes.  Returns (out [B, Q] chosen tokens,
        n_emitted [B] in 1..q_lens: the leading run of accepted drafts + the
        correction token, bad [B]: with ``guard`` the guard's flags, a slot
        flagged when a live row is not finite; else None)."""
        B, Q = tokens.shape
        dev = self.device
        x = self._rows_forward(tokens, pos, active, q_lens, table,
                               verify=True)
        logits = lm_head_logits(self.cfg, self.params, x)         # [B, Q, V]
        t = torch.arange(Q, device=dev)
        bad = None
        if guard:
            # only the live rows count: rows past q_lens read garbage
            # positions and may be non-finite
            logits, bad = self._guard_logits(
                logits, active, poison, live=t[None, :] < q_lens[:, None])
        self.last_logits = logits[:, 0]
        flat_rows = None
        if rows is not None:     # every row of a sampled lane draws
            flat_rows = (rows[:, None] * Q + t[None, :]).reshape(-1)
        out = self._sample_tokens(
            logits.reshape(B * Q, -1), (pos[:, None] + t).reshape(-1),
            temp.repeat_interleave(Q), topp.repeat_interleave(Q),
            seeds.repeat_interleave(Q), flat_rows).reshape(B, Q)
        ok = (tokens[:, 1:] == out[:, :-1]) & (t[None, 1:] < q_lens[:, None])
        n_emitted = 1 + torch.cumprod(ok.long(), dim=1).sum(dim=1)
        return out, n_emitted, bad

    # ---------------- prefill ----------------

    def _prefill_body(self, ids, length, bucket, write, start=0):
        """Embed/rope/mask once, the paged write path injected.  ``ids``
        holds the tokens at absolute positions start .. start + bucket - 1
        (``start`` > 0: a prefix-cache hit's tail), so rope and the causal
        mask shift by ``start``; positions at or beyond ``length`` (the
        absolute total) are padding, masked out of attention.  No logits:
        the last prompt token is fed to the first decode step."""
        cfg = self._body_cfg    # TP: the rank's head counts
        S = self.max_seq
        x = self.params["embed"][ids].to(cfg.dtype)
        q_pos = start + torch.arange(bucket, device=self.device)
        safe = q_pos.clamp(max=S - 1)            # the bucket may overrun S
        cos = self._cos[:, safe]
        sin = self._sin[:, safe]
        q_pos = q_pos[None, None, None, :, None]
        kv_pos = torch.arange(S, device=self.device)[None, None, None, None, :]
        mask = (kv_pos <= q_pos) & (kv_pos < length)
        transformer_apply(cfg, self.params, x, self.cache_k, self.cache_v,
                          write, mask, cos, sin, quant=self.quant,
                          tp_group=self._tp_group)

    def _prefill_impl(self, ids, slot, length, bucket):
        """Prefill one request (batch 1, ``ids`` [1, bucket] padded) into
        lane ``slot`` of the dense pools: positions [0, bucket) of the lane
        take the bucket's K/V (padding too: decode overwrites a position
        before the causal mask lets it be read), and attention reads that
        lane alone."""

        def write(ck, k):
            # ck [B, nkv, S, hd] a layer's lanes; k [1, bucket, nkv, hd]
            ck[slot, :, :bucket] = k[0].transpose(0, 1)
            return ck, ck[slot:slot + 1]

        self._prefill_body(ids, length, bucket, write)

    def _prefill_impl_paged(self, ids, table_row, start, length, bucket):
        """Prefill positions [start, length) into the slot's pages: ``ids``
        [1, bucket] holds the tokens at absolute positions start .. start +
        bucket - 1, padded; position j writes page table_row[j // bs] offset
        j % bs.  Attention reads the slot's whole row, whose leading pages
        are a prefix-cache hit's shared prefix; writes land only in [start,
        length), so a shared page is never written (the admission's
        copy-on-write makes the first decode position's page private too).
        Padding and positions past max_seq go to the spill page (fp pools)
        or drop out of the requantize, which requantizes each dirty page
        once: a garbage pad row in the prompt's tail page would inflate
        that page's scale and coarsen its real rows' codes for good."""
        cfg = self._body_cfg    # TP: the rank's kv heads
        S, bs = self.max_seq, self.block_size
        nkv, hd = cfg.num_key_value_heads, cfg.head_dim
        pos_j = start + torch.arange(bucket, device=self.device)
        keep = (pos_j < length) & (pos_j < S)
        row = table_row.long()

        if self.kv_quant is not None:
            write = self._quant_rows_write(table_row[None], pos_j[None],
                                           keep[None])
        else:
            safe_j = pos_j.clamp(max=S - 1)
            blk_j = torch.where(keep, row[safe_j // bs],
                                torch.full_like(pos_j, self.num_blocks))
            off_j = safe_j % bs

            def write(ck, k):
                # k [1, bucket, nkv, hd] -> each position into its page (in
                # place); view = this slot's gathered pages, batch 1
                ck[blk_j, :, off_j] = k[0]
                view = ck[row].transpose(0, 1).reshape(1, nkv, S, hd)
                return ck, view

        self._prefill_body(ids, length, bucket, write, start)

    def _copy_page(self, dst: int, src: int):
        """Copy-on-write: pool page ``src`` into page ``dst`` across every
        layer, in place (a quantized pool's codes and scales together).
        Under TP each rank copies its own kv heads of the page."""
        for pool in (self.cache_k, self.cache_v):
            for a in (pool.values() if isinstance(pool, dict) else (pool,)):
                a[:, dst].copy_(a[:, src])

    def _quant_rows_write(self, table, row_pos, valid, view=True):
        """write_fn for a multi-row event into quantized pools: the
        page-batched requantize (``quant_append_rows``: only dirty pages
        change), then what attention reads.  A prefill bucket
        (``view=True``) reads a dequantized gather of the slot's pages in
        the model dtype (batch 1); sentinel entries read the spill page,
        whose codes and scale stay zero, so they read as zeros like the
        reference's fill.  The mixed and verify steps (``view=False``) read
        the pools themselves through the paged walks."""
        cfg = self._body_cfg    # TP: the rank's kv heads
        S = self.max_seq
        nkv, hd = cfg.num_key_value_heads, cfg.head_dim
        kvq = self.kv_quant
        pages = table[0].long()

        def write(ck, k):
            _pa.quant_append_rows(ck["q"], ck["scale"], k, table, row_pos,
                                  valid, kvq)
            if not view:
                return ck, ck
            view_ = _pa._dequant_page_content(ck["q"][pages],
                                              ck["scale"][pages], kvq)
            view_ = view_.transpose(0, 1).reshape(1, nkv, S, hd)
            return ck, view_.to(cfg.dtype)

        return write

    # ---------------- block allocator (host control plane) ----------------

    def _blocks_needed(self, last_pos: int) -> int:
        return min(last_pos, self.max_seq - 1) // self.block_size + 1

    def _alloc_to(self, slot: int, n_blocks: int) -> bool:
        """Grow slot to n_blocks pages (its shared cached prefix counts);
        False if the pool runs dry.  Under prefix caching a dry free list
        first LRU-evicts a zero-ref cached block: eviction happens only
        here (and in ladder rung 1), so hot prefixes go last."""
        owned = self._slot_blocks[slot]
        base = len(self._slot_shared[slot])
        if (base + len(owned) < n_blocks and self._faults
                and self._faults.fire("alloc_fail", step=self._step_no,
                                      slot=slot)):
            # the allocator seam: report the pool dry, polled only where a
            # real grab would happen
            self._record("fault", fault="alloc_fail", slot=slot,
                         step=self._step_no)
            return False
        while base + len(owned) < n_blocks:
            # with the tier, reclaim the whole deficit in one call (one
            # gathered read demotes the batch); without it, one page at a
            # time, so the page order stays the pre-tier engine's
            want = (n_blocks - base - len(owned) if self._tier is not None
                    else 1)
            if not self._free and not self._reclaim(want):
                return False
            b = self._free.pop()
            self._table[slot, base + len(owned)] = b
            owned.append(b)
        return True

    def _reclaim(self, n: int) -> int:
        """Evict up to n zero-ref cached blocks into the free list; with the
        host tier, each victim's page is demoted to the host first, so its
        chain stays re-admittable."""
        if self._pcache is None:
            return 0
        with RecordEvent("prefix_cache/evict"):
            pairs = self._pcache.evict(n)
        if pairs:
            if self._tier is not None:
                self._demote(pairs)
            self._free.extend(page for _, page in pairs)
            self.stats["prefix_evictions"] += len(pairs)
            self._record("evict", pages=len(pairs))
        return len(pairs)

    # ---------------- the host KV tier: demote / restore ----------------

    def _pool_leaves(self):
        """((K pages, K scales), (V pages, V scales)): each pool's fp pages
        or codes, and its per-(page, kv head) scales (None on fp pools)."""
        if self.kv_quant is None:
            return ((self.cache_k, None), (self.cache_v, None))
        return ((self.cache_k["q"], self.cache_k["scale"]),
                (self.cache_v["q"], self.cache_v["scale"]))

    def _demote(self, pairs):
        """ship_out the evicted pages: ONE gathered device read of the
        batch, then each page's slice into the tier, whose copy blocks
        until the bytes are on the host, so the pages return to the free
        list only once no later kernel can overwrite them first.  A page
        the tier cannot fit goes dead (the tier counts it in ``drops``).
        Under TP each rank's tier holds its own kv heads of each page and
        counts the whole page's bytes (``shards``), as the reference's tier
        counts its gathered page, so every rank's tier makes the
        reference's budget decisions."""
        with RecordEvent("kv_tier/demote"):
            idx = torch.as_tensor([page for _, page in pairs],
                                  device=self.device)
            (k, ks), (v, vs) = ((a[:, idx], None if sc is None
                                 else sc[:, idx])
                                for a, sc in self._pool_leaves())
            owner = self._obs_labels.get("replica")
            for i, (h, _page) in enumerate(pairs):
                if self._tier.ship_out(
                        h, k[:, i], v[:, i],
                        k_scale=None if ks is None else ks[:, i],
                        v_scale=None if vs is None else vs[:, i],
                        owner=owner, shards=self.tp) is not None:
                    self.stats["tier_demotions"] += 1
            self.stats["tier_bytes"] = self._tier.used_bytes
            self.stats["tier_evictions"] = self._tier.evictions
            self._record("tier_demote", pages=len(pairs),
                         tier_bytes=int(self._tier.used_bytes))

    def _tier_write(self, dst: int, entry):
        """ship_in's device half: the entry's host page into pool page
        ``dst`` across every layer, in place, a quantized pool's codes and
        scales together (as ``_copy_page`` copies).  From page-locked
        memory the copies are asynchronous on the current stream, ordered
        before every later kernel that reads the page.  Under TP the entry
        holds this rank's kv heads of the page (``_demote``)."""
        for (a, sc), page, scale in zip(self._pool_leaves(),
                                        (entry.k, entry.v),
                                        (entry.k_scale, entry.v_scale)):
            a[:, dst].copy_(page, non_blocking=True)
            if sc is not None:
                sc[:, dst].copy_(scale, non_blocking=True)

    def _restore_tier_block(self, slot: int, req, ids, b: int, h: str,
                            parent: str | None) -> bool:
        """Re-admit ONE demoted block: take a free page, copy the host page
        into it and register the block in the prefix cache with this slot
        holding a reference, as a freshly prefilled block.  False when it
        cannot (pool dry, a tier miss or an injected ``tier_drop``, private
        pages ahead of the shared front, an entry of another pool format):
        the caller prefills the block instead, with the same tokens."""
        bs = self.block_size
        if self._faults and self._faults.fire("tier_drop",
                                              step=self._step_no,
                                              slot=slot, rid=req.rid):
            # the tier seam: the entry vanishes between match and restore
            self._tier.discard(h)
            self._record("fault", fault="tier_drop", slot=slot,
                         step=self._step_no)
        if h in self._pcache._by_hash:
            # another slot restored or computed the block since the plan
            # was made: map the resident copy
            e = self._pcache._by_hash[h]
            self._pcache.acquire(e)
            self._table[slot, len(self._slot_shared[slot])] = e.page
            self._slot_shared[slot].append(h)
            return True
        if not self._free or self._slot_blocks[slot]:
            # pool pressure, or private pages ahead of the shared front (a
            # cache_error left them there): compute instead
            return False
        entry = self._tier.ship_in(h, owner=self._obs_labels.get("replica"))
        if entry is None:
            return False
        # a shared tier may hold pages of another pool format: a miss
        pool = self._pool_leaves()[0][0]
        if ((entry.k_scale is not None) != (self.kv_quant is not None)
                or tuple(entry.k.shape) != (pool.shape[0],) + pool.shape[2:]
                or entry.k.dtype != pool.dtype):
            return False
        dst = self._free.pop()
        t0 = time.perf_counter()
        with RecordEvent("kv_tier/restore"):
            self._tier_write(dst, entry)
        e = self._pcache.register(parent, ids[b * bs:(b + 1) * bs], dst,
                                  refcount=1)
        if e is None:
            # the parent left the index since the plan: the page would be
            # unreachable; hand it back and compute the block instead
            self._free.append(dst)
            return False
        self._table[slot, len(self._slot_shared[slot])] = dst
        self._slot_shared[slot].append(h)
        self.stats["tier_readmits"] += 1
        self.stats["tier_bytes"] = self._tier.used_bytes
        if self._h_h2d is not None:
            self._h_h2d.observe(time.perf_counter() - t0)
        self._record("tier_readmit", rid=req.rid, slot=slot, block=b,
                     page=dst)
        return True

    def _tier_restore_step(self, s: int, ids,
                           budget: int) -> tuple[int, int, bool]:
        """The chunked cursor's restore loop for slot ``s``: plan blocks
        the cursor already passed (computed by a fallback chunk) drop;
        while the cursor sits at a planned block's start, restore it and
        advance the cursor a block.  Each restored block bills
        ``block_size`` tokens of the step's budget, one block at least a
        step, so a long chain cannot burst into one step.  Returns
        (cursor, budget left, pending): ``pending``, a planned block still
        at the cursor (deferred by the budget), idles the lane this step
        rather than compute a block the next step restores."""
        bs = self.block_size
        req = self._slot_req[s]
        plan = self._tier_plan[s]
        cur = int(self._prefilled[s])
        restored = 0
        while plan:
            b, h, parent = plan[0]
            if b * bs < cur:
                plan.pop(0)                 # computed by a fallback chunk
                self._tier.unpin(h)
                continue
            if b * bs != cur:
                break                       # mid-block cursor: compute on
            if restored > 0 and budget < bs:
                return cur, budget, True    # the next step goes on
            if not self._restore_tier_block(s, req, ids, b, h, parent):
                # pool dry, or the entry vanished: drop the WHOLE plan and
                # prefill the rest
                self._drop_tier_plan(s)
                break
            plan.pop(0)
            self._tier.unpin(h)
            restored += 1
            budget = max(budget - bs, 0)
            cur += bs
            self._prefilled[s] = cur
            self._pos[s] = cur
            self._written[s] = max(int(self._written[s]), cur)
            # admission counted the whole uncached tail as computed; this
            # block's tokens were restored
            self.stats["prefill_tokens_computed"] -= bs
            self.stats["prefill_tokens_cached"] += bs
        return cur, budget, False

    def _drop_tier_plan(self, slot: int):
        """Drop a slot's pending restore plan (preempt, cancel, terminal, a
        failed restore), unpinning what is left of it; blocks already
        restored stay ordinary cached blocks."""
        if self._tier is None:
            return
        for _b, h, _p in self._tier_plan[slot]:
            self._tier.unpin(h)
        self._tier_plan[slot] = []

    def _evictable(self) -> int:
        return (self._pcache.evictable_count() if self._pcache is not None
                else 0)

    def _release(self, slot: int):
        self._drop_tier_plan(slot)
        self._free.extend(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        # shared pages are refcounted, not freed: at zero refs they stay
        # resident until eviction needs them
        for h in self._slot_shared[slot]:
            self._pcache.release(h)
        self._slot_shared[slot] = []
        self._table[slot, :] = self.num_blocks

    def _register_prefix_blocks(self, slot: int, ids: np.ndarray,
                                valid_len: int):
        """After a prefill (or a streamed chunk): move the freshly computed
        full blocks below ``valid_len`` beyond the shared prefix into the
        cache, this slot holding a reference, so an admission later in the
        same step already hits.  They leave the FRONT of the private list,
        which keeps the row [shared..., private...]."""
        bs = self.block_size
        n_shared = len(self._slot_shared[slot])
        limit = valid_len // bs            # blocks fully written
        if limit <= n_shared:
            return
        if self._faults and self._faults.fire("cache_error",
                                              step=self._step_no, slot=slot):
            # the cache seam: the blocks stay private (a later request
            # misses where it could have hit) and no request fails
            if not self._graceful:
                raise FaultInjected(f"injected cache_error (step "
                                    f"{self._step_no}, slot {slot})")
            return
        parent = self._slot_shared[slot][-1] if n_shared else None
        for b in range(n_shared, limit):
            e = self._pcache.register(parent, ids[b * bs:(b + 1) * bs],
                                      self._slot_blocks[slot][0], refcount=1)
            if e is None:
                break        # already cached or orphaned: stays private
            if self._tier is not None and not self._tier.shared:
                # the block was computed afresh: a private tier's copy of
                # it goes (a block lives in the pool or in the tier)
                self._tier.discard(e.hash)
            parent = e.hash
            self._slot_blocks[slot].pop(0)
            self._slot_shared[slot].append(e.hash)

    def _register_retired_blocks(self, slot: int):
        """Before a finishing, preempted, cancelled or expired slot is
        released: donate its full private blocks to the cache as zero-ref
        residents, so the prefix (prompt AND generated tokens, the stream a
        preempted request resumes with) survives.  Positions are trusted
        only below min(pos, len(prompt + output), max_seq): writes past the
        delivered tokens hold garbage and are never content-addressed."""
        if self._pcache is None:
            return
        req = self._slot_req[slot]
        seq = np.concatenate([np.asarray(req.prompt_ids, np.int32).ravel(),
                              np.asarray(req.output_ids, np.int32)])
        trusted = min(int(self._pos[slot]), seq.size, self.max_seq)
        bs = self.block_size
        n_shared = len(self._slot_shared[slot])
        limit = trusted // bs
        if limit <= n_shared:
            return
        parent = self._slot_shared[slot][-1] if n_shared else None
        keep: list[int] = []
        for i, page in enumerate(self._slot_blocks[slot]):
            b = n_shared + i
            if b < limit:
                tokens = seq[b * bs:(b + 1) * bs]
                e = self._pcache.register(parent, tokens, page, refcount=0)
                if e is not None:
                    if self._tier is not None and not self._tier.shared:
                        self._tier.discard(e.hash)   # as registration does
                    parent = e.hash
                    continue               # the cache owns the page now
                # duplicate content: the page stays private, later blocks
                # chain through the existing entry's id
                parent = self._pcache.chain_hash(parent, tokens)
            keep.append(page)
        self._slot_blocks[slot] = keep

    def _preempt(self, slot: int):
        """Recompute preemption: free the slot, requeue the request with
        prompt + generated-so-far at the head of the queue, keeping its
        seniority.  Its full blocks go to the prefix cache first, so the
        resume recomputes from the first uncached token.  Resume
        teacher-forces the stored tokens, and sampled draws are keyed by
        (seed, position), so the stream continues exactly."""
        req = self._slot_req[slot]
        req._resume_ids = np.concatenate(
            [np.asarray(req.prompt_ids, np.int32).ravel(),
             np.asarray(req.output_ids, np.int32)])
        req._resume_age = int(self._slot_age[slot])
        self._register_retired_blocks(slot)
        self._release(slot)
        self._slot_req[slot] = None
        self._written[slot] = 0
        self._temp[slot] = 0.0  # re-set on readmission
        if self._chunked:
            # a mid-prefill victim resumes as a fresh admission
            self._prefill_ids[slot] = None
            self._prefilled[slot] = 0
        req.status = "PENDING"
        self._queue.insert(0, req)
        self._jmark(req.rid)
        self.stats["preemptions"] += 1
        self._record("degrade", rung=4, what="preempt", rid=req.rid,
                     slot=slot)
        if self._graceful:
            # under pressure, a preemption is ladder rung 4
            self.stats["degrade_preempt"] += 1

    def _ensure_growth(self, k):
        """Before a step: every active slot needs pages covering positions
        up to pos+k-1 (``k`` may be a per-slot vector: the verify step
        appends q_lens rows to each slot and the mixed step a chunk or one
        token).  Oldest slots win; when the pool is dry the youngest other
        active slot is preempted.  With no victim left, graceful mode fails
        only this request (rung 5); graceful off raises."""
        karr = np.broadcast_to(np.asarray(k, np.int64), (self.max_batch,))
        order = sorted((s for s in range(self.max_batch)
                        if self._slot_req[s] is not None),
                       key=lambda s: self._slot_age[s])
        for slot in order:
            if self._slot_req[slot] is None:
                continue  # preempted by an older slot this pass
            last = int(self._pos[slot]) + int(karr[slot]) - 1
            need = self._blocks_needed(last)
            while not self._alloc_to(slot, need):
                victims = [s for s in range(self.max_batch)
                           if s != slot and self._slot_req[s] is not None]
                if not victims:
                    req = self._slot_req[slot]
                    have = (len(self._slot_shared[slot])
                            + len(self._slot_blocks[slot]))
                    pinned = (self._pcache.resident_blocks()
                              - self._pcache.evictable_count()
                              if self._pcache is not None else 0)
                    msg = (f"KV block pool exhausted by a single request: "
                           f"rid={req.rid} needs {need} block(s) to cover "
                           f"position {last} ({have} mapped, "
                           f"{len(self._free)} free, {self._evictable()} "
                           f"evictable cached, {pinned} pinned cached, "
                           f"{self.num_blocks} total); increase num_blocks")
                    if self._graceful:
                        self._fail_slot(slot, "FAILED", msg, donate=True)
                        break
                    raise RuntimeError(msg)
                self._preempt(max(victims, key=lambda s: self._slot_age[s]))

    # ---------------- scheduler ----------------

    def _validate(self, req: Request):
        ids = np.asarray(req.prompt_ids, np.int32).ravel()
        if ids.size == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if ids.size > self.max_seq - 1:
            raise ValueError(f"request {req.rid}: prompt length {ids.size} "
                             f"exceeds max_seq-1 = {self.max_seq - 1}")
        temp = req.temperature if req.temperature is not None else 0.0
        if not math.isfinite(temp) or temp < 0:
            raise ValueError(f"request {req.rid}: temperature must be "
                             f"finite and >= 0, got {temp!r}")
        topp = req.top_p if req.top_p is not None else 1.0
        if not (math.isfinite(topp) and 0 < topp <= 1):
            raise ValueError(f"request {req.rid}: top_p must be finite and "
                             f"in (0, 1], got {topp!r}")
        if (req.deadline_s is not None
                and not (math.isfinite(req.deadline_s)
                         and req.deadline_s >= 0)):
            raise ValueError(f"request {req.rid}: deadline_s must be finite "
                             f"and >= 0, got {req.deadline_s!r}")

    def add_request(self, req: Request):
        self._validate(req)
        req.prompt_ids = np.asarray(req.prompt_ids, np.int32).ravel()
        req._submit_s = time.perf_counter()  # TTFT and deadline epoch
        if req.trace_id is None:
            req.trace_id = f"req-{req.rid:x}"
        if self.slo is not None:
            self.slo.begin(req.rid, req._submit_s)
        self._reqs[req.rid] = req
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            msg = (f"queue full ({len(self._queue)} waiting, "
                   f"max_queue={self.max_queue})")
            if not self._graceful:
                raise RuntimeError(f"request {req.rid}: {msg}")
            with RecordEvent("serving/rejected"):
                self._terminal(req, "REJECTED", msg)
            return
        self._queue.append(req)
        self._jmark(req.rid)

    def _admit(self):
        """Fill free slots from the queue.  The dense engine seats the head
        request whenever a lane is free and prefills its prompt into the
        lane.  The paged engine admits by pages (``_map_prompt``), and a
        bucketed admission prefills the uncached tail now (stalling the
        resident slots' decode for it); a chunked one only enqueues it for
        the mixed steps to stream, mapping its pages chunk by chunk in
        graceful mode."""
        for slot in range(self.max_batch):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            req = self._queue[0]
            ids = getattr(req, "_resume_ids", None)
            if ids is None:
                ids = np.asarray(req.prompt_ids, np.int32).ravel()
            s0 = ids.size
            start, tier_plan = 0, []
            if self.paged:
                mapped = self._map_prompt(slot, req, ids)
                if mapped is None:
                    break  # pool dry: keep queue order, retry next step
                start, tier_plan = mapped
            self._queue.pop(0)
            for attr in ("_resume_ids", "_resume_age"):
                if hasattr(req, attr):
                    delattr(req, attr)
            plen = (s0 - 1) - start
            self.stats["prefill_tokens_cached"] += start
            self.stats["prefill_tokens_computed"] += max(plen, 0)
            if self._chunked:
                # enqueue without prefill: the mixed steps stream positions
                # [start, s0), and the last one (the last prompt token)
                # emits the first generated token
                self._prefill_ids[slot] = ids
                self._prefilled[slot] = start
                # the cursor is the position state: pos and _written move
                # with each chunk (cached positions below start count as
                # written: the pool holds their K/V)
                self._pos[slot] = start
                self._written[slot] = start
                if self._tier is not None:
                    # the cursor restores the plan's blocks as it reaches
                    # them (_tier_restore_step)
                    self._tier_plan[slot] = tier_plan
            else:
                if start == 0 or plen > 0:
                    self._prefill_tail(req, slot, ids, start, s0)
                # else: a full hit, nothing to compute
                self._pos[slot] = s0 - 1
                # K/V is in the pool below s0-1; s0-1 is decode's first
                # write
                self._written[slot] = s0 - 1
                if self._pcache is not None:
                    self._register_prefix_blocks(slot, ids, s0 - 1)
            self._slot_req[slot] = req
            req.status = "RUNNING"
            # the queue-wait span closes at seating; the decode span opens
            now = time.perf_counter()
            req._admit_s = now
            if self.slo is not None:
                self.slo.admitted(req.rid, now)
            self._tracer.span(req.rid, "queued",
                              getattr(req, "_submit_s", now), now,
                              args={"rid": req.rid, "slot": slot,
                                    "cached_tokens": int(start)})
            self._record("admit", rid=req.rid, slot=slot, prompt=int(s0),
                         cached_tokens=int(start))
            self._last_tok[slot] = ids[-1]
            self._temp[slot] = max(float(req.temperature or 0.0), 0.0)
            self._topp[slot] = float(req.top_p if req.top_p is not None
                                     else 1.0)
            # default seed: the request id, so two concurrent sampled
            # requests never share a stream
            self._seed[slot] = np.int32(
                req.seed if req.seed is not None else req.rid)
            self._jmark(req.rid)   # seating sets the journal's cursor

    def _map_prompt(self, slot: int, req: Request, ids: np.ndarray):
        """The paged admission of ``req`` (stream ``ids``) onto the free
        ``slot``: it enters only when its prompt's pages, plus the
        resident slots' imminent growth (the next decode chunk, or a verify
        step's K+1 rows), fit in the free pool and the evictable cache.
        The longest cached chain of its full blocks is mapped read-only; a
        block-aligned full hit copies its last block into a private page
        (copy-on-write: decode writes there); the host tier extends the
        match.  Returns (start, tier plan): the first position whose K/V
        must be computed and the chunked cursor's restore plan; or None
        when the pool is dry (the slot is left empty)."""
        bs = self.block_size
        s0 = ids.size
        horizon = max(self.chunk, self._spec_qmax)
        # per-slot clamp at 0: a mid-prefill slot owns its whole prompt's
        # pages while pos (its cursor) trails them
        headroom = sum(
            max(0, self._blocks_needed(int(self._pos[s]) + horizon - 1)
                - len(self._slot_shared[s]) - len(self._slot_blocks[s]))
            for s in range(self.max_batch)
            if self._slot_req[s] is not None)
        need = self._blocks_needed(s0 - 1)
        gate = self._blocks_needed(s0 - 2 + horizon)
        # pin the match BEFORE any allocation: a referenced block cannot be
        # evicted from under it
        matched = self._pcache.match(ids) if self._pcache else []
        m = len(matched)
        # a block-aligned full hit would put the first decode write
        # (position s0-1) inside the last matched block: copy it
        cow = m > 0 and m * bs > s0 - 1
        n_map = m - 1 if cow else m
        for e in matched:
            self._pcache.acquire(e)
        for i, e in enumerate(matched[:n_map]):
            self._table[slot, i] = e.page
            self._slot_shared[slot].append(e.hash)
        # the host tier: extend the match through it, strictly below the
        # first decode write (s0-1), so a restored block is never written;
        # a full device hit (COW) has no tail to extend
        tier_plan: list[tuple[int, str, str | None]] = []
        if self._tier is not None and not cow:
            parent = matched[-1].hash if m else None
            b = m
            while (b + 1) * bs <= s0 - 1:
                h = self._pcache.chain_hash(parent, ids[b * bs:(b + 1) * bs])
                if h not in self._tier:
                    break
                tier_plan.append((b, h, parent))
                parent = h
                b += 1
            if tier_plan:
                self.stats["tier_hits"] += 1
                for _b, h, _p in tier_plan:
                    # pinned until restored or dropped: the plan may span
                    # steps
                    self._tier.pin(h)
                self._record("tier_match", rid=req.rid,
                             blocks=len(tier_plan))
        n_restored = 0
        if tier_plan and not (self._chunked and self._graceful):
            # the bucketed engine, and the chunked one with graceful off (it
            # maps the whole prompt's private pages now, so the cursor has
            # no block boundary to restore at), restore at admission; a
            # failure (pool dry, tier_drop) prefills the rest
            for b, h, parent in tier_plan:
                if not self._restore_tier_block(slot, req, ids, b, h,
                                                parent):
                    break
                n_restored += 1
            for _b, h, _p in tier_plan:
                self._tier.unpin(h)
            tier_plan = []
        if self._chunked and self._graceful:
            # chunk-granular mapping: the mixed steps' _ensure_growth maps
            # each chunk's pages, so rung 3 can shrink a chunk instead of
            # preempting; only the COW page exists now
            need = m if cow else n_map
        avail = len(self._free) + self._evictable()
        if (avail < gate - (n_map + n_restored) + headroom
                or not self._alloc_to(slot, need)):
            # restored blocks stay cached at zero refs (a retry hits them);
            # a chunked plan's pins go
            if cow:
                self._pcache.release(matched[-1].hash)
            for _b, h, _p in tier_plan:
                self._tier.unpin(h)
            self._release(slot)
            return None
        if cow:
            src = matched[-1]
            with RecordEvent("prefix_cache/cow_copy"):
                self._copy_page(self._slot_blocks[slot][0], src.page)
            self._pcache.release(src.hash)   # content copied: unpin
            self.stats["cow_copies"] += 1
        if m:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_blocks_reused"] += m
        age = getattr(req, "_resume_age", None)
        self._slot_age[slot] = self._admit_seq if age is None else age
        self._admit_seq += 1
        # prefill starts at the first uncached token (a shared, COW or
        # restored block's K/V is in the pool), never past s0-1 (decode's
        # first position)
        return min((m + n_restored) * bs, s0 - 1), tier_plan

    def _prefill_tail(self, req: Request, slot: int, ids: np.ndarray,
                      start: int, s0: int):
        """The bucketed admission's prefill of positions [start, s0-1): the
        whole prompt but its last token (fed to decode) when ``start`` is
        0, else the uncached tail after a prefix-cache hit."""
        # a whole-prompt prefill while other slots are seated stalls their
        # decode for the prompt's length
        stalls = any(r is not None for r in self._slot_req)
        n = s0 - 1 - start
        bucket = min(_bucket(n), self.max_seq)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = ids[start:s0 - 1]
        dev = self.device
        ids_t = torch.as_tensor(padded, device=dev).long()
        t_pf = time.perf_counter()
        if not self.paged:
            self._prefill_impl(ids_t, slot, s0 - 1, bucket)
        else:
            # a prefix-cache hit's uncached tail has a span of its own
            with (RecordEvent("prefix_cache/partial_prefill") if start
                  else contextlib.nullcontext()):
                self._prefill_impl_paged(
                    ids_t, torch.as_tensor(self._table[slot], device=dev),
                    start, s0 - 1, bucket)
        self._sync()
        t_end = time.perf_counter()
        self.prefill_time_s += t_end - t_pf
        self.stats["prefills"] += 1
        self.stats["decode_stall_steps"] += int(stalls)
        self._tracer.span(req.rid, "prefill", t_pf, t_end,
                          args={"bucket": bucket, "tokens": n,
                                **({"cached": start} if start else {})})

    def _retire(self, slot):
        self._terminal(self._slot_req[slot], "FINISHED")
        self._vacate(slot, donate=True)

    # ---------------- fault tolerance ----------------

    def _terminal(self, req: Request, status: str, error: str | None = None):
        """Move a request to its terminal status (once).  ``finished`` is
        the caller's "no more tokens" flag for every terminal status;
        ``status`` says why."""
        req.status = status
        req.finished = True
        if error is not None:
            req.error = error
        stat = _STATUS_STAT.get(status)
        if stat is not None:
            self.stats[stat] += 1
        self._reqs.pop(req.rid, None)
        self._jdrop(req.rid)     # the journal holds live requests only
        # close the SLO record, emit the decode span (admission to now) and
        # the terminal marker; a FAILED request dumps the flight recorder
        now = time.perf_counter()
        if self.slo is not None:
            self.slo.finish(req.rid, status, now)
        if self._tracer.enabled:
            t_admit = getattr(req, "_admit_s", None)
            if t_admit is not None:
                self._tracer.span(req.rid, "decode", t_admit, now,
                                  args={"tokens": len(req.output_ids),
                                        "status": status})
            self._tracer.instant(req.rid, f"terminal:{status}", now,
                                 args={"rid": req.rid,
                                       **({"error": error} if error else {})})
        self._record("terminal", rid=req.rid, status=status,
                     tokens=len(req.output_ids),
                     **({"error": error} if error else {}))
        if status == "FAILED" and self._flight is not None:
            self._flight.dump(f"request_failed rid={req.rid}")

    def _fail_slot(self, slot: int, status: str, error: str,
                   donate: bool = False):
        """End the request seated on ``slot`` with a terminal status other
        than FINISHED, releasing every page and cache reference it holds.
        ``donate=True`` (cancel, expiry, overload: the slot's K/V is
        trusted) gives its full blocks to the prefix cache first, as
        retirement does; ``donate=False`` (the NaN guard and other faults)
        drops them, since a faulty step's K/V must never serve a later
        request.  Output already banked stays on the request."""
        req = self._slot_req[slot]
        with RecordEvent(f"serving/{status.lower()}"):
            self._vacate(slot, donate)
            self._terminal(req, status, error)

    def _vacate(self, slot: int, donate: bool):
        """Empty a slot whose request has ended: with ``donate`` its full
        blocks go to the prefix cache first (they need the request's
        tokens), then every page and cache reference is released (the
        dense engine's lane holds neither)."""
        if donate:
            self._register_retired_blocks(slot)
        self._slot_req[slot] = None
        self._written[slot] = 0
        self._temp[slot] = 0.0
        self._poison[slot] = False
        if self._chunked:
            self._prefill_ids[slot] = None
            self._prefilled[slot] = 0
        if self.paged:
            self._release(slot)

    def _host_fault(self, kind: str, slot: int | None = None,
                    rid: int | None = None):
        """Poll one host-side seam; raises :class:`FaultInjected` when a plan
        clause fires."""
        if self._faults and self._faults.fire(kind, step=self._step_no,
                                              slot=slot, rid=rid):
            where = "".join((f", slot {slot}" if slot is not None else "",
                             f", rid {rid}" if rid is not None else ""))
            self._record("fault", fault=kind, step=self._step_no,
                         **({"slot": slot} if slot is not None else {}),
                         **({"rid": rid} if rid is not None else {}))
            raise FaultInjected(
                f"injected {kind} (step {self._step_no}{where})")

    def _arm_poison(self):
        """The sampler seam: set the poison bit of each slot a
        ``nan_logits`` clause fires on this step (graceful mode only)."""
        if not (self._graceful and self._faults):
            return
        for s in range(self.max_batch):
            req = self._slot_req[s]
            if req is not None and self._faults.fire(
                    "nan_logits", step=self._step_no, slot=s, rid=req.rid):
                self._poison[s] = True
                # the port records the armed fault too (the reference's
                # recorder sees only the guard's terminal record), so the
                # victim's dump holds its fault
                self._record("fault", fault="nan_logits", slot=s,
                             rid=req.rid, step=self._step_no)

    def _dispatch_fault(self) -> bool:
        """The dispatch seam, polled before a step's first launch: True when
        an injected ``kernel_error`` fired and graceful mode retries the
        step (host and device state are untouched: nothing launched).
        Graceful off, or past the retry limit, it raises.  Only the
        injected fault is retried: an error a kernel wrapper raises comes
        from the launch itself, outside this seam, and propagates."""
        try:
            self._host_fault("kernel_error")
        except FaultInjected:
            if not self._graceful:
                raise
            self._kernel_err_streak += 1
            self.stats["kernel_error_retries"] += 1
            self._record("fault", fault="kernel_error",
                         streak=self._kernel_err_streak, step=self._step_no)
            if self._kernel_err_streak > self._kernel_err_limit:
                raise
            with RecordEvent("serving/kernel_error_retry"):
                pass
            return True
        self._kernel_err_streak = 0
        return False

    def _guard_kw(self) -> dict:
        """A step's guard operands: ``guard`` in graceful mode (graceful off
        the step runs no guard), and the poison bits on the device only on
        a step where a ``nan_logits`` clause armed one (else no NaN row is
        added)."""
        poison = (torch.as_tensor(self._poison, device=self.device)
                  if self._poison.any() else None)
        return {"guard": self._graceful, "poison": poison}

    def _growth_need(self, growth) -> int:
        """Pages the active slots' imminent growth needs beyond what they
        own (``growth`` may be a per-slot vector)."""
        karr = np.broadcast_to(np.asarray(growth, np.int64),
                               (self.max_batch,))
        need = 0
        for s in range(self.max_batch):
            if self._slot_req[s] is None or karr[s] <= 0:
                continue
            need += max(0, self._blocks_needed(int(self._pos[s])
                                               + int(karr[s]) - 1)
                        - len(self._slot_shared[s])
                        - len(self._slot_blocks[s]))
        return need

    def _degrade_reclaim(self, growth) -> int:
        """Ladder rung 1: under pool pressure evict prefix-cache leaves
        (oldest zero-ref first) ahead of the allocator.  Returns the deficit
        left; <= 0 means the step fits."""
        need = self._growth_need(growth)
        short = need - len(self._free)
        if short > 0 and self._evictable() > 0:
            with RecordEvent("serving/degrade_evict"):
                if self._reclaim(short) > 0:
                    self.stats["degrade_evict"] += 1
                    self._record("degrade", rung=1, what="evict",
                                 short=int(short))
        return need - len(self._free)

    def _expire_overdue(self):
        """Deadlines (graceful mode): a request past its ``deadline_s`` ends
        EXPIRED with the output it has, queued or running, freeing its
        pages for requests that can still make theirs.  Under tensor
        parallelism the ranks' clocks differ, so the overdue set is their
        union, and every rank expires the same requests at the same step."""
        live = [r for r in self._slot_req if r is not None] + self._queue
        timed = [r for r in live if r.deadline_s is not None]
        if not timed:
            return
        now = time.perf_counter()
        late = [now - getattr(r, "_submit_s", now) > r.deadline_s
                for r in timed]
        if self.tp > 1:
            # one max all-reduce of the flags; ``timed`` is replicated
            # state (the same requests in the same order on every rank),
            # so every rank reaches it at the same step
            t = torch.tensor(late, dtype=torch.int32, device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._tp_group)
            late = t.tolist()
        late = {r.rid for r, x in zip(timed, late) if x}
        if not late:
            return
        for s in range(self.max_batch):
            req = self._slot_req[s]
            if req is not None and req.rid in late:
                self._fail_slot(s, "EXPIRED",
                                f"deadline_s={req.deadline_s} exceeded "
                                f"({len(req.output_ids)} token(s) delivered)",
                                donate=True)
        keep = []
        for req in self._queue:
            if req.rid in late:
                with RecordEvent("serving/expired"):
                    self._terminal(req, "EXPIRED",
                                   f"deadline_s={req.deadline_s} exceeded "
                                   f"while queued")
            else:
                keep.append(req)
        self._queue = keep

    def cancel(self, rid: int) -> bool:
        """Cancel a request: a queued one leaves the queue, a running one
        frees its slot (mid-prefill too; its full blocks go to the prefix
        cache).  Output already banked stays on the request.  True when the
        request was live; False for an unknown or terminal rid.  Graceful
        mode only.  Under tensor parallelism every rank must cancel the
        same rid between the same two steps, as it adds requests."""
        if not self._graceful:
            raise RuntimeError("cancel() requires PADDLE_TPU_GRACEFUL=1")
        req = self._reqs.get(rid)
        if req is None or req.status in TERMINAL_STATUSES:
            return False
        for s in range(self.max_batch):
            if self._slot_req[s] is req:
                self._fail_slot(s, "CANCELLED", "cancelled by caller",
                                donate=True)
                return True
        with RecordEvent("serving/cancelled"):
            # by identity: the dataclass __eq__ compares numpy prompts
            self._queue = [q for q in self._queue if q is not req]
            self._terminal(req, "CANCELLED", "cancelled by caller")
        return True

    # ---------------- snapshot / restore ----------------

    def _topology(self) -> dict:
        """What a restore target must agree on for a snapshot to replay:
        the model and the serving geometry, formatted as the reference
        formats them (dtype names ``float32`` / ``bfloat16``), so a
        snapshot of either package restores on the other.  ``tp`` is
        recorded, never enforced (the pool is not captured: a restore
        recomputes, whatever the degree)."""
        cfg = self.cfg
        dt = str(cfg.dtype).replace("torch.", "")
        return {
            "model": (f"llama:v{cfg.vocab_size}:h{cfg.hidden_size}"
                      f":L{cfg.num_hidden_layers}"
                      f":nh{cfg.num_attention_heads}"
                      f":nkv{cfg.num_key_value_heads}"
                      f":i{cfg.intermediate_size}"
                      f":tie{int(bool(cfg.tie_word_embeddings))}"
                      f":dt{dt}:rope{cfg.rope_theta:g}"
                      f":eps{cfg.rms_norm_eps:g}"),
            "quant": self.quant,
            "kv_quant": self.kv_quant,
            "paged": self.paged,
            "block_size": self.block_size if self.paged else None,
            "max_seq": int(self.max_seq),
            "tp": int(self.tp),
        }

    def snapshot(self) -> dict:
        """The accepted, unfinished work as JSON-ready data: the running
        requests in seniority order, then the queue, each as a
        :func:`journal_entry` (prompt, emitted tokens, sampling, the
        remaining deadline, the chunk cursor), under the engine's
        topology.  The KV pool is not captured: :meth:`restore` resumes by
        teacher-forced recompute, exact for greedy and seeded sampling."""
        now = time.perf_counter()
        self.stats["journal_full_rebuilds"] += 1
        with RecordEvent("serving/snapshot"):
            return {
                "version": 2,
                "engine": self._topology(),
                "running": [journal_entry(self._slot_req[s],
                                          self._cursor(s), now)
                            for s in self._running_slots()],
                "queued": [journal_entry(r, 0, now) for r in self._queue],
            }

    def _running_slots(self) -> list[int]:
        """The seated slots: in seniority order on the paged engine, in
        lane order on the dense one (which keeps no ages), as the
        reference lists them."""
        seated = [s for s in range(self.max_batch)
                  if self._slot_req[s] is not None]
        if self.paged:
            seated.sort(key=lambda s: int(self._slot_age[s]))
        return seated

    def _cursor(self, slot: int) -> int:
        """A seated slot's chunk cursor, as a journal entry records it."""
        return int(self._prefilled[slot]) if self._chunked else 0

    # ---------------- the incremental journal ----------------

    def _jmark(self, rid: int):
        """Mark one rid's journal entry stale (admission, a token banked,
        a cursor advance, adopt, preempt); :meth:`_jflush` rebuilds it."""
        self._jdirty.add(rid)

    def _jdrop(self, rid: int):
        """Retire one rid's journal entry (a terminal status)."""
        self._jentries.pop(rid, None)
        self._jdirty.discard(rid)

    def _jflush(self, now: float | None = None):
        """Rebuild the entries of every dirty rid: O(changed requests), in
        place of :meth:`snapshot`'s full scan.  An entry freezes
        ``deadline_remaining_s`` at the flush; :meth:`journal` recomputes
        it when read."""
        if not self._jdirty:
            return
        t0 = time.perf_counter()
        if now is None:
            now = t0
        slot_of = {r.rid: s for s, r in enumerate(self._slot_req)
                   if r is not None}
        n = 0
        for rid in self._jdirty:
            req = self._reqs.get(rid)
            if req is None:
                self._jentries.pop(rid, None)
                continue
            s = slot_of.get(rid)
            self._jentries[rid] = journal_entry(
                req, 0 if s is None else self._cursor(s), now)
            n += 1
        self._jdirty.clear()
        if n:
            self.stats["journal_incremental_updates"] += n
            if self._h_jupdate is not None:
                self._h_jupdate.observe(time.perf_counter() - t0)
            self._record("journal_flush", entries=n)

    def journal(self) -> dict:
        """:meth:`snapshot`'s document assembled from the incremental
        journal (flushed first), with each deadline's remaining budget as
        of now."""
        now = time.perf_counter()
        self._jflush(now)

        def entry(req, cursor: int) -> dict:
            e = self._jentries.get(req.rid)
            if e is None:
                # a rid never marked (every mutation site marks) journals
                # all the same
                e = self._jentries[req.rid] = journal_entry(req, cursor, now)
            if e["deadline_s"] is not None:
                e = dict(e, deadline_remaining_s=max(
                    0.0, e["deadline_s"]
                    - (now - getattr(req, "_submit_s", now))))
            return e

        return {
            "version": 2,
            "engine": self._topology(),
            "running": [entry(self._slot_req[s], self._cursor(s))
                        for s in self._running_slots()],
            "queued": [entry(r, 0) for r in self._queue],
        }

    def _host_overlap(self):
        """The host work that needs no token, run between a step's last
        launch and its one host fetch, while the card executes the queued
        kernels: the journal's flush.  Nothing with
        ``PADDLE_TPU_ASYNC_HOST=0``."""
        if not self._async_host:
            return
        self.stats["host_overlap_steps"] += 1
        self._jflush()

    def adopt(self, j: dict) -> Request:
        """Queue ONE journaled request (an entry of a snapshot): it enters
        through the preemption-resume path, its emitted tokens
        teacher-forced, and its deadline re-armed with the journaled
        remaining budget (the full ``deadline_s`` for an entry without
        one).  Exempt from ``max_queue``: the work was accepted once."""
        req = Request(
            rid=j["rid"],
            prompt_ids=np.asarray(j["prompt_ids"], np.int32),
            max_new_tokens=j["max_new_tokens"],
            eos_token_id=j["eos_token_id"],
            temperature=j["temperature"], top_p=j["top_p"],
            seed=j["seed"],
            deadline_s=j.get("deadline_remaining_s", j["deadline_s"]))
        req.output_ids = list(j["output_ids"])
        if req.output_ids:
            req._resume_ids = np.concatenate(
                [np.asarray(req.prompt_ids, np.int32).ravel(),
                 np.asarray(req.output_ids, np.int32)])
        req._submit_s = time.perf_counter()
        req.trace_id = f"req-{req.rid:x}"
        if self.slo is not None:
            self.slo.begin(req.rid, req._submit_s)
        self._tracer.instant(req.rid, "adopt", req._submit_s,
                             args={"rid": req.rid,
                                   "replayed_tokens": len(req.output_ids)})
        self._record("adopt", rid=req.rid,
                     replayed_tokens=len(req.output_ids))
        self._reqs[req.rid] = req
        self._queue.append(req)
        self._jmark(req.rid)
        return req

    def restore(self, snap: dict) -> list[Request]:
        """Resume a :meth:`snapshot` on this engine: every journaled request
        re-enters the queue (running ones first) through :meth:`adopt`, so
        the completed serve emits the uninterrupted serve's tokens.  A
        version other than 1 or 2, or a topology that differs in anything
        but ``tp``, raises ``ValueError`` naming each differing field.
        Returns the resumed requests."""
        if snap.get("version") not in (1, 2):
            raise ValueError(f"unknown snapshot version "
                             f"{snap.get('version')!r} (expected 1 or 2)")
        src = snap.get("engine")
        if snap.get("version") == 2 and src is not None:
            mine = self._topology()
            mismatch = {k: (src.get(k), mine[k]) for k in mine
                        if k != "tp" and src.get(k) != mine[k]}
            if mismatch:
                diff = "; ".join(f"{k}: snapshot={a!r} vs engine={b!r}"
                                 for k, (a, b) in sorted(mismatch.items()))
                raise ValueError(
                    f"snapshot topology does not match this engine "
                    f"({diff}); restoring across topologies would resume "
                    f"silently wrong - only the tensor-parallel degree "
                    f"may differ (snapshot tp={src.get('tp')!r}, engine "
                    f"tp={self.tp})")
        with RecordEvent("serving/restore"):
            return [self.adopt(j) for j in snap["running"] + snap["queued"]]

    # ---------------- the step ----------------

    def step(self) -> bool:
        """One admit + device iteration with one host fetch: while any
        prompt streams in (chunked prefill), ONE mixed prefill/decode step;
        else, with speculation on and at least one slot drafting, ONE
        multi-token verify step; else ``chunk`` decode steps.  Returns False
        when idle.  Graceful mode: no per-request fault leaves this method;
        the request it touches ends, and every other stream is what a run
        without that request emits."""
        self._step_no += 1          # the fault plan's step key (1-based)
        if self._graceful:
            self._expire_overdue()
        self._admit()
        if (self._graceful and self.paged and self._queue
                and all(r is None for r in self._slot_req)):
            # nothing resident and nothing admitted: no later step frees a
            # page, so after a few stuck steps (a transient injected fault
            # clears) fail the head request (rung 5 at admission)
            self._admit_stalls += 1
            if self._admit_stalls > self._kernel_err_limit:
                req = self._queue.pop(0)
                ids = getattr(req, "_resume_ids", None)
                s0 = (np.asarray(req.prompt_ids).size if ids is None
                      else ids.size)
                with RecordEvent("serving/failed"):
                    self._terminal(
                        req, "FAILED",
                        f"pool exhausted at admission: rid={req.rid} needs "
                        f"{self._blocks_needed(s0 - 1)} block(s) for its "
                        f"{s0}-token stream, {len(self._free)} free + "
                        f"{self._evictable()} evictable of "
                        f"{self.num_blocks} total")
                self._admit_stalls = 0
        else:
            self._admit_stalls = 0
        self._maybe_audit()
        if self._chunked and any(i is not None for i in self._prefill_ids):
            return self._mixed_step()
        if self._spec is not None:
            drafts = self._draft_proposals()
            if drafts is not None and self._graceful:
                qlens = np.ones(self.max_batch, np.int64)
                for s, d in drafts.items():
                    qlens[s] = 1 + d.size
                if self._degrade_reclaim(qlens) > 0:
                    # rung 2: the drafts' appends do not fit even after
                    # rung 1: decode one token a slot this step (the
                    # stream does not change, only tokens a round-trip)
                    with RecordEvent("serving/degrade_spec_off"):
                        self.stats["degrade_spec_off"] += 1
                        self._record("degrade", rung=2, what="spec_off",
                                     step=self._step_no)
                    drafts = None
            if drafts is not None:
                return self._spec_step(drafts)
            # no slot drafted: the ordinary decode path, at no extra cost
        k = self.chunk
        if self.paged:
            if self._graceful:
                self._degrade_reclaim(k)    # rung 1 before rung 4
            self._ensure_growth(k)  # may preempt the youngest slot
        active_np = np.asarray([r is not None for r in self._slot_req])
        if not active_np.any():
            return False
        t0 = time.perf_counter()
        self._note_launch(t0)
        self._arm_poison()
        if self._dispatch_fault():
            return True         # retried next step, state untouched
        dev = self.device
        sampled_lanes = [s for s in range(self.max_batch)
                         if active_np[s] and self._temp[s] > 0]
        toks, bad = self._chunk_scan(
            torch.as_tensor(self._last_tok, device=dev).long(),
            torch.as_tensor(self._pos, device=dev).long(),
            torch.as_tensor(active_np, device=dev),
            torch.as_tensor(self._temp, device=dev),
            torch.as_tensor(self._topp, device=dev),
            torch.as_tensor(self._table, device=dev) if self.paged else None,
            torch.as_tensor(self._seed, device=dev),
            torch.as_tensor(sampled_lanes, dtype=torch.long, device=dev)
            if sampled_lanes else None, **self._guard_kw())
        self._poison[:] = False
        # ONE host round-trip per chunk: tokens and guard flags together
        if bad is not None:
            toks = torch.cat([toks, bad.long()])
        self._host_overlap()    # while the card runs the launches above
        fetched = toks.cpu().numpy()
        toks_np, bad_np = fetched[:k], fetched[k:]
        self.stats["decode_time_s"] += time.perf_counter() - t0
        self._note_step_done(t0)
        now = self._last_step_end   # the SLO tracker's banking time
        self.stats["decode_steps"] += k
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            old_pos = int(self._pos[slot])
            # tokens produced from positions >= max_seq are garbage (their
            # K/V writes were dropped)
            valid = min(k, self.max_seq - old_pos)
            done = False
            banked = 0
            fail_err = None
            try:
                self._host_fault("slot_error", slot=slot, rid=req.rid)
            except FaultInjected as e:
                if not self._graceful:
                    raise
                fail_err = str(e)
            for j in range(valid if fail_err is None else 0):
                if bad is not None and bad_np[j, slot]:
                    # quarantine: tokens from the poisoned step on were
                    # drawn from a zeroed row and are never banked
                    self.stats["nan_guard_trips"] += 1
                    fail_err = (f"non-finite logits at position "
                                f"{old_pos + j} (in-graph guard)")
                    break
                tok = int(toks_np[j, slot])
                req.output_ids.append(tok)
                banked += 1
                if req.ttft_s is None:
                    req.ttft_s = time.perf_counter() - req._submit_s
                self.stats["decode_tokens"] += 1
                if (len(req.output_ids) >= req.max_new_tokens
                        or (req.eos_token_id is not None
                            and tok == req.eos_token_id)):
                    done = True
                    break
            if fail_err is not None:
                # fail THIS slot; the other lanes' tokens bank normally
                self._fail_slot(slot, "FAILED", fail_err, donate=False)
                continue
            if self.slo is not None and banked:
                # one banking event: the chunk's tokens arrive in one fetch
                self.slo.tokens(req.rid, banked, now)
            self._pos[slot] = old_pos + k  # device advanced k regardless
            # a maximum: an earlier verify step's rejected drafts may sit
            # past old_pos + k, and the mark covers them until overwritten
            self._written[slot] = max(int(self._written[slot]),
                                      min(old_pos + k, self.max_seq))
            self._last_tok[slot] = int(toks_np[-1, slot])
            self._jmark(req.rid)   # the bank advanced the journal entry
            if done or old_pos + k >= self.max_seq:
                self._retire(slot)
        self._maybe_audit()
        return True

    # ---------------- chunked prefill: the mixed step (host side) ----------

    def _device_args(self, active):
        """The per-slot sampling state and the block table on the device,
        and the sampled lanes among the ``active`` ones (None: none)."""
        dev = self.device
        sampled = [s for s in range(self.max_batch)
                   if active[s] and self._temp[s] > 0]
        return (torch.as_tensor(self._temp, device=dev),
                torch.as_tensor(self._topp, device=dev),
                torch.as_tensor(self._seed, device=dev),
                torch.as_tensor(self._table, device=dev),
                torch.as_tensor(sampled, dtype=torch.long, device=dev)
                if sampled else None)

    def _mixed_step(self) -> bool:
        """One mixed prefill/decode round: pack up to ``token_budget`` rows
        as [decode slots | prefill chunks] and run ONE device step.  Decode
        rows pack FIRST (every decode-ready slot advances a token, so decode
        never waits on a prompt), then prefill chunks fill the remaining
        budget oldest slot first, at most ``prefill_chunk`` rows a slot,
        with a one-row floor.  Graceful mode: when the step's growth does
        not fit even after evicting cache leaves (rung 1), the prefill rows
        shrink to one a slot (rung 3) before anyone is preempted.  A lane
        whose chunk reaches its last prompt token consumes the emitted
        token (its first generated token); mid-prompt lanes ignore theirs.
        Each chunk's full blocks go to the prefix cache as it lands.  One
        host fetch."""
        B = self.max_batch
        T = self._prefill_chunk
        decode_slots = [s for s in range(B)
                        if self._slot_req[s] is not None
                        and self._prefill_ids[s] is None]
        budget = max(self._token_budget - len(decode_slots), 1)
        tokens = np.zeros((B, T), np.int32)
        q_lens = np.ones(B, np.int32)
        pos = self._pos.copy()                  # row-0 positions
        active = np.zeros(B, bool)
        growth = np.zeros(B, np.int64)
        chunk_rows: dict[int, int] = {}
        for s in decode_slots:
            tokens[s, 0] = self._last_tok[s]
            active[s] = True
            growth[s] = 1
        prefilling = sorted((s for s in range(B)
                             if self._prefill_ids[s] is not None),
                            key=lambda s: self._slot_age[s])
        tier_progress = False
        t_r0 = None        # the first restore's dispatch (host-gap anchor)
        for s in prefilling:
            ids = self._prefill_ids[s]
            cur = int(self._prefilled[s])
            if self._tier is not None and self._tier_plan[s]:
                # the host tier: the cursor restores its plan's blocks
                # first, billed to the same token budget as prefill rows;
                # a plan the budget defers idles the lane
                cur0 = cur
                if t_r0 is None:
                    t_r0 = time.perf_counter()
                cur, budget, pending = self._tier_restore_step(s, ids,
                                                               budget)
                tier_progress = tier_progress or cur != cur0 or pending
                if cur != cur0:
                    self._jmark(self._slot_req[s].rid)  # cursor advanced
                if pending:
                    continue
            n = min(T, ids.size - cur, budget)
            if n <= 0:
                continue    # budget drained: the lane idles this step
            budget -= n
            tokens[s, :n] = ids[cur:cur + n]
            pos[s] = cur
            q_lens[s] = n
            active[s] = True
            growth[s] = n
            chunk_rows[s] = n
        if self._graceful and self._degrade_reclaim(growth) > 0:
            shrinkable = [s for s, n in chunk_rows.items() if n > 1]
            if shrinkable:
                with RecordEvent("serving/degrade_budget_shrink"):
                    self.stats["degrade_budget_shrink"] += 1
                    self._record("degrade", rung=3, what="budget_shrink",
                                 slots=len(shrinkable))
                for s in shrinkable:
                    tokens[s, 1:] = 0
                    q_lens[s] = growth[s] = chunk_rows[s] = 1
        self._last_pack = (tuple(decode_slots), tuple(sorted(chunk_rows)))
        self._ensure_growth(growth)  # may preempt the youngest slot
        for s in range(B):
            if self._slot_req[s] is None:       # preempted after packing
                active[s] = False
                chunk_rows.pop(s, None)
        if not active.any():
            if tier_progress and t_r0 is not None:
                # a restore-only step: its host-to-device copies are the
                # step's device work, observed as a step
                self._note_launch(t_r0)
                self._note_step_done(t_r0)
            # restores are progress: the serve loop spins on until the
            # plan drains
            return bool(self._queue) or tier_progress
        t0 = time.perf_counter()
        self._note_launch(t0)
        # the step's packing: what the scheduler chose, for triage
        self._record("pack", step=self._step_no, decode=len(decode_slots),
                     prefill=len(chunk_rows),
                     prefill_rows=int(sum(chunk_rows.values())))
        self._arm_poison()
        if self._dispatch_fault():
            return True         # retried next step, state untouched
        dev = self.device
        nxt, bad = self._mixed_impl(
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(pos, device=dev).long(),
            torch.as_tensor(active, device=dev),
            torch.as_tensor(q_lens, device=dev).long(),
            *self._device_args(active), **self._guard_kw())
        self._poison[:] = False
        # ONE host round-trip: the tokens and the guard flags together
        fetched = nxt if bad is None else torch.stack([nxt, bad.long()])
        self._host_overlap()    # while the card runs the launches above
        fetched = fetched.cpu().numpy()
        nxt_np, bad_np = (fetched, None) if bad is None else fetched
        self.stats["decode_time_s"] += time.perf_counter() - t0
        self._note_step_done(t0)
        self.stats["decode_steps"] += 1
        self.stats["mixed_steps"] += 1
        self.stats["prefill_chunks"] += len(chunk_rows)
        for s in decode_slots:
            req = self._slot_req[s]
            if req is None:
                continue            # preempted by _ensure_growth
            if bad_np is not None and bad_np[s]:
                self.stats["nan_guard_trips"] += 1
                self._fail_slot(s, "FAILED",
                                f"non-finite logits at position "
                                f"{int(self._pos[s])} (in-graph guard)")
                continue
            try:
                self._host_fault("slot_error", slot=s, rid=req.rid)
            except FaultInjected as e:
                if not self._graceful:
                    raise
                self._fail_slot(s, "FAILED", str(e))
                continue
            old_pos = int(self._pos[s])
            self._pos[s] = old_pos + 1
            self._written[s] = max(int(self._written[s]),
                                   min(old_pos + 1, self.max_seq))
            self._consume_token(s, req, int(nxt_np[s]))
            if self._slot_req[s] is not None and old_pos + 1 >= self.max_seq:
                self._retire(s)
        for s, n in chunk_rows.items():
            req = self._slot_req[s]
            if req is None:
                continue
            if bad_np is not None and bad_np[s]:
                # the forward that computed this chunk's K/V is not
                # trusted: fail the request before any of it is banked
                self.stats["nan_guard_trips"] += 1
                self._fail_slot(s, "FAILED",
                                f"non-finite logits while prefilling "
                                f"(cursor {int(self._prefilled[s])}; "
                                f"in-graph guard)")
                continue
            ids = self._prefill_ids[s]
            new_cur = int(self._prefilled[s]) + n
            self._prefilled[s] = new_cur
            self._jmark(req.rid)   # the chunk cursor advanced
            self._tracer.span(req.rid, "prefill_chunk", t0,
                              self._last_step_end,
                              args={"rows": n, "cursor": new_cur,
                                    "prompt": int(ids.size)})
            self._pos[s] = new_cur
            self._written[s] = max(int(self._written[s]),
                                   min(new_cur, self.max_seq))
            if self._pcache is not None:
                # every position below new_cur holds a prompt token's K/V
                self._register_prefix_blocks(s, ids, new_cur)
            if new_cur >= ids.size:
                # final chunk: its emit row sat at the last prompt token
                self._prefill_ids[s] = None
                self._prefilled[s] = 0
                self._consume_token(s, req, int(nxt_np[s]))
                if self._slot_req[s] is not None and new_cur >= self.max_seq:
                    self._retire(s)
        self._maybe_audit()
        return True

    def _consume_token(self, slot: int, req: Request, tok: int):
        """Bank one generated token of a mixed step (one banking event):
        append, stamp TTFT, count it, feed it back, retire on EOS or the
        token budget."""
        req.output_ids.append(tok)
        if req.ttft_s is None:
            req.ttft_s = time.perf_counter() - req._submit_s
        if self.slo is not None:
            self.slo.tokens(req.rid, 1, self._last_step_end)
        self.stats["decode_tokens"] += 1
        self._last_tok[slot] = tok
        self._jmark(req.rid)   # the bank advanced the journal entry
        if (len(req.output_ids) >= req.max_new_tokens
                or (req.eos_token_id is not None
                    and tok == req.eos_token_id)):
            self._retire(slot)

    # ---------------- speculation (host side) ----------------

    def _draft_proposals(self) -> dict[int, np.ndarray] | None:
        """The drafter over every seated slot's prompt + generated history:
        {slot: drafts} when at least one slot proposed something, else None
        (the caller then takes the ordinary decode path).  Drafts are capped
        so the verify step never writes past max_seq nor drafts past the
        request's remaining token budget."""
        out: dict[int, np.ndarray] = {}
        any_draft = False
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            cap = min(self.max_seq - 1 - int(self._pos[slot]),
                      req.max_new_tokens - len(req.output_ids) - 1)
            if cap <= 0:
                out[slot] = np.zeros(0, np.int32)
                continue
            ctx = np.concatenate(
                [np.asarray(req.prompt_ids, np.int32).ravel(),
                 np.asarray(req.output_ids, np.int32)])
            d = self._spec.propose(ctx)[:cap]
            out[slot] = d
            any_draft = any_draft or d.size > 0
        return out if any_draft else None

    def _spec_step(self, drafts: dict[int, np.ndarray]) -> bool:
        """One draft-verify-accept round: grow pages for every slot's
        appends, run the verify step once (ONE host fetch for up to K+1
        tokens a slot), bank the accepted run + the correction token, and
        roll ``pos`` back past rejected drafts.  Their K/V stay in the pool
        above ``pos`` until overwritten (on quantized pools they take part
        in their page's requantize, as in the reference); no cache
        registration trusts a position at or above ``pos``."""
        B = self.max_batch
        Q = self._spec_qmax
        qlens = np.ones(B, np.int64)
        for s, d in drafts.items():
            qlens[s] = 1 + d.size
        self._ensure_growth(qlens)  # may preempt the youngest slot
        active_np = np.asarray([r is not None for r in self._slot_req])
        if not active_np.any():
            return False
        tokens = np.zeros((B, Q), np.int32)
        tokens[:, 0] = self._last_tok
        q_lens = np.ones(B, np.int32)
        for s, d in drafts.items():
            if self._slot_req[s] is None or d.size == 0:
                continue  # preempted after drafting, or no proposal
            tokens[s, 1:1 + d.size] = d
            q_lens[s] = 1 + d.size
        t0 = time.perf_counter()
        self._note_launch(t0)
        self._arm_poison()
        if self._dispatch_fault():
            return True         # retried next step, state untouched
        dev = self.device
        out, n_acc, bad = self._verify_impl(
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(self._pos, device=dev).long(),
            torch.as_tensor(active_np, device=dev),
            torch.as_tensor(q_lens, device=dev).long(),
            *self._device_args(active_np), **self._guard_kw())
        self._poison[:] = False
        # ONE host round-trip: tokens, accepted counts and guard flags
        cols = [out, n_acc[:, None]]
        if bad is not None:
            cols.append(bad.long()[:, None])
        fetched = torch.cat(cols, dim=1)
        self._host_overlap()    # while the card runs the launches above
        fetched = fetched.cpu().numpy()
        out_np, n_np = fetched[:, :Q], fetched[:, Q]
        self.stats["decode_time_s"] += time.perf_counter() - t0
        self._note_step_done(t0)
        now = self._last_step_end   # the SLO tracker's banking time
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            old_pos = int(self._pos[slot])
            if bad is not None and fetched[slot, Q + 1]:
                # the slot's whole verify output is discarded
                self.stats["nan_guard_trips"] += 1
                self._fail_slot(slot, "FAILED",
                                f"non-finite logits at position {old_pos} "
                                f"(verify step; in-graph guard)")
                continue
            try:
                self._host_fault("slot_error", slot=slot, rid=req.rid)
            except FaultInjected as e:
                if not self._graceful:
                    raise
                self._fail_slot(slot, "FAILED", str(e))
                continue
            n = int(n_np[slot])        # 1..q_lens: accepted run + correction
            drafted = int(q_lens[slot]) - 1
            self.stats["spec_drafted_tokens"] += drafted
            self.stats["spec_accepted_tokens"] += n - 1
            self.stats["spec_rejected_tokens"] += drafted - (n - 1)
            done = False
            banked = 0
            for j in range(n):
                tok = int(out_np[slot, j])
                req.output_ids.append(tok)
                banked += 1
                if req.ttft_s is None:
                    req.ttft_s = time.perf_counter() - req._submit_s
                self.stats["decode_tokens"] += 1
                if (len(req.output_ids) >= req.max_new_tokens
                        or (req.eos_token_id is not None
                            and tok == req.eos_token_id)):
                    done = True     # EOS or the token budget
                    break
            if self.slo is not None:
                # one banking event: the accepted run arrives in one fetch
                self.slo.tokens(req.rid, banked, now)
            # the rollback: pos passes the accepted run only, the mark
            # keeps how far the device wrote (a shorter draft after a long
            # rejected one must not shrink it)
            self._written[slot] = max(int(self._written[slot]),
                                      min(old_pos + int(q_lens[slot]),
                                          self.max_seq))
            self._pos[slot] = old_pos + n
            self._last_tok[slot] = int(out_np[slot, n - 1])
            self._jmark(req.rid)   # the accepted run advanced the entry
            if done or old_pos + n >= self.max_seq:
                self._retire(slot)
        self._maybe_audit()
        return True

    @property
    def spec_acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verify step accepted (0.0 before
        any speculative step, and with speculation off)."""
        d = self.stats["spec_drafted_tokens"]
        return self.stats["spec_accepted_tokens"] / d if d > 0 else 0.0

    def serve(self, requests: list[Request]) -> dict[int, list[int]]:
        """Run all requests to completion; returns {rid: generated tokens}.
        Graceful mode: an invalid request ends REJECTED (with ``error``)
        and the rest are served.  Graceful off, validation is
        all-or-nothing: any bad request raises before anything is
        enqueued."""
        if self._graceful:
            for r in requests:
                try:
                    self.add_request(r)
                except ValueError as e:
                    with RecordEvent("serving/rejected"):
                        self._terminal(r, "REJECTED", str(e))
        else:
            for r in requests:
                self._validate(r)
            for r in requests:
                self.add_request(r)
        while self.step() or self._queue:
            pass
        return {r.rid: r.output_ids for r in requests}

    @property
    def decode_tokens_per_s(self) -> float:
        t = self.stats["decode_time_s"]
        return self.stats["decode_tokens"] / t if t > 0 else 0.0
