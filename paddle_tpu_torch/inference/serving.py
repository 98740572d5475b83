"""Continuous-batching serving engine, paged subset (counterpart of
``paddle_tpu/inference/serving.py``).

Ported: ``Request``, ``_bucket`` and the ``ContinuousBatchingEngine`` path
``serve`` -> ``add_request`` -> ``step`` -> ``_admit`` ->
``_prefill_impl_paged`` -> ``_decode_one`` -> ``_sample_tokens``, with
its block allocator (``_alloc_to``, ``_release``), preemption
(``_preempt``, ``_ensure_growth``) and retirement; fp or quantized KV
pools (``kv_quant``); the three decode arms of ``_decode_one``: the
fused step (one kernel a layer, fp or quantized pools), and the unfused
arm the ``fused_decode_step`` / ``fused_quant_append`` switches rebuild the
engine on (an append, then the paged decode attention); chunked prefill
(``enable_chunked_prefill``: prompts stream in ``prefill_chunk``-row
chunks through one mixed prefill/decode step a round, ``_mixed_step``)
and n-gram speculative decoding (``enable_speculation``: prompt-lookup
drafts checked by one multi-token verify step, ``_spec_step``), each
token-identical to the bucketed, speculation-off engine.  Not ported yet
(ROADMAP.md): the dense-cache mode, prefix cache, weight-only quant,
tensor parallelism, the graceful fault ladder, metrics, the journal and
async host runtime, snapshot/restore and the fleet.  Invalid requests
therefore raise (the reference's ``PADDLE_TPU_GRACEFUL=0`` contract), and
a chunked admission maps its whole prompt's pages at once, as the
reference does in that mode.

How the JAX engine's mechanisms map to PyTorch:

- compiled programs become eager calls: the decode step is a Python loop
  over layers whose per-layer work on the fused arm is two CUDA kernel
  launches (the fused decode step and the fused MLP half) plus the
  rms_norm kernel and plain matmuls;
- the donated KV pools become preallocated pool tensors
  ``[L, num_blocks + 1, nkv, block_size, head_dim]`` updated IN PLACE
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
  Greedy streams are the JAX engine's tokens.
"""

from __future__ import annotations

import math
import os
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..ops import decode_attention as _da
from ..ops.kernels import kernel_disabled
from ..ops.kernels import paged_attention as _pa
from ..ops.kernels import rope as rope_mod
from ..ops.kernels import sampling
from . import lm_head_logits, transformer_apply
from .speculative import NGramDrafter

_warned_env: set[tuple[str, str]] = set()


def _env_bool(name: str, default: bool) -> bool:
    """A boolean kill switch: '' -> default, '0' -> False, '1' -> True; any
    other value warns once and keeps the default (the reference's
    ``utils/envflags.env_bool``: a typo must not flip a switch)."""
    raw = os.environ.get(name, "")
    if raw in ("", "0", "1"):
        return default if raw == "" else raw == "1"
    if (name, raw) not in _warned_env:
        _warned_env.add((name, raw))
        warnings.warn(f"{name}={raw!r} is not '0' or '1'; using the default "
                      f"({'1' if default else '0'})")
    return default


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
    # filled by the engine
    output_ids: list = field(default_factory=list)
    finished: bool = False
    ttft_s: float | None = None  # submit -> first generated token (wall s)
    # PENDING (queued) -> RUNNING (seated) -> FINISHED; preemption moves a
    # RUNNING request back to PENDING
    status: str = "PENDING"


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class ContinuousBatchingEngine:
    """Slot-pool continuous batching over a Llama-family model with a paged
    (block-table) KV cache.

    ``cfg``/``params`` follow ``paddle_tpu_torch.models.llama`` (the
    reference's layout; ``utils/convert.py`` bridges a JAX parameter tree).
    ``device`` defaults to the CUDA card and must hold ``params``.
    ``kv_quant``: None | 'int8' | 'int4' -- quantized KV pools (the
    reference's ``paged=True`` mode, implied here): pages hold int8 codes
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
    """

    def __init__(self, cfg, params, max_batch: int = 8, max_seq: int = 512,
                 chunk: int = 1, block_size: int = 64,
                 num_blocks: int | None = None, kv_quant: str | None = None,
                 enable_speculation: bool = False, num_draft_tokens: int = 4,
                 spec_ngram: int = 3, enable_chunked_prefill: bool = False,
                 prefill_chunk: int = 128, token_budget: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        for leaf in [params["embed"], *params["layers"].values()]:
            if leaf.device != self.device:
                raise ValueError(f"params live on {leaf.device}, engine "
                                 f"device is {self.device}")
        if max_seq % block_size:
            raise ValueError(f"max_seq {max_seq} is not a multiple of "
                             f"block_size {block_size}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.chunk = int(chunk)
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
        nkv, hd = cfg.num_key_value_heads, cfg.head_dim
        if kv_quant is not None:
            if kv_quant not in ("int8", "int4"):
                raise ValueError(f"kv_quant must be None, 'int8' or "
                                 f"'int4', got {kv_quant!r}")
            if kv_quant == "int4" and hd % 2:
                raise ValueError(f"kv_quant='int4' needs an even head_dim "
                                 f"(got {hd}): two nibbles pack per byte")
        self.kv_quant = kv_quant
        # the decode arm, decided here as the reference decides it: the
        # fused step unless a switch rebuilds the engine on the unfused arm
        # (an append, then the paged decode attention, which still runs its
        # kernels).  The fused MLP half rides the fused arm only.
        self._fused = not (kernel_disabled("paged_attention")
                           or kernel_disabled("fused_decode_step")
                           or (kv_quant is not None
                               and kernel_disabled("fused_quant_append")))
        self._fused_mlp = self._fused and not kernel_disabled("fused_layer_mlp")
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
        cos, sin = rope_mod.rope_cos_sin(max_seq, hd, base=cfg.rope_theta,
                                         dtype=cfg.dtype, device=self.device)
        self._cos, self._sin = cos, sin             # [1, max_seq, hd]
        # host allocator state; sentinel num_blocks = unallocated (it
        # resolves to the spill page, whose reads are always masked)
        self._free: list[int] = list(range(self.num_blocks))
        self._slot_blocks: list[list[int]] = [[] for _ in range(max_batch)]
        self._table = np.full((max_batch, self.max_blocks), self.num_blocks,
                              np.int32)
        self._admit_seq = 0
        self._slot_age = np.zeros(max_batch, np.int64)
        # slot state (host side)
        self._slot_req: list[Request | None] = [None] * max_batch
        self._pos = np.zeros(max_batch, np.int32)      # next write position
        self._last_tok = np.zeros(max_batch, np.int32)
        self._temp = np.zeros(max_batch, np.float32)
        self._topp = np.ones(max_batch, np.float32)
        self._seed = np.zeros(max_batch, np.int32)
        self._queue: list[Request] = []
        # speculation and chunked prefill: every behaviour of each hangs
        # off self._spec / self._chunked, and the kill switch is read FIRST,
        # so =0 turns the feature off whatever the arguments say
        self._spec = None
        self._spec_qmax = 0            # the verify step's rows a slot, K+1
        if enable_speculation and _env_bool("PADDLE_TPU_SPECULATE", True):
            self._spec = NGramDrafter(num_draft_tokens=num_draft_tokens,
                                      max_ngram=spec_ngram)
            self._spec_qmax = int(num_draft_tokens) + 1
        self._chunked = False
        if enable_chunked_prefill and _env_bool("PADDLE_TPU_CHUNKED_PREFILL",
                                                True):
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
        self.stats = {"decode_steps": 0, "decode_tokens": 0,
                      "decode_time_s": 0.0, "prefills": 0,
                      "prefill_time_s": 0.0, "preemptions": 0,
                      "decode_stall_steps": 0, "mixed_steps": 0,
                      "prefill_chunks": 0, "spec_steps": 0,
                      "spec_drafted_tokens": 0, "spec_accepted_tokens": 0,
                      "spec_rejected_tokens": 0}
        #: logits [B, V] of the last step run (inspection only): a decode
        #: step's, a mixed step's emit rows, a verify step's row 0
        self.last_logits: torch.Tensor | None = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------- decode step ----------------

    def _decode_one(self, tokens, pos, active, table):
        """One batched decode step: tokens/pos [B] int64, active [B] bool,
        table [B, max_blocks] int32 (all on the device) -> logits [B, V].
        On the fused arm, rope + the page append (requantizing for
        quantized pools) + split-K attention run as ONE kernel launch per
        layer and the post-attention half as another.  The unfused arm
        ropes, appends (a row scatter, or the requantized page append) and
        attends through ``paged_decode_attention``.  Dropped writes land on
        the spill page or nowhere; inactive lanes compute garbage that is
        never read."""
        cfg = self.cfg
        B, S, bs = self.max_batch, self.max_seq, self.block_size
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        kvq = self.kv_quant
        x = self.params["embed"][tokens][:, None].to(cfg.dtype)   # [B, 1, h]
        writeable = active & (pos < S)
        safe_pos = torch.where(writeable, pos, torch.zeros_like(pos))
        cos = self._cos[0][safe_pos]                              # [B, hd]
        sin = self._sin[0][safe_pos]
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
                                    mlp_fused_fn=mlp_fused_fn)
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

    def _chunk_scan(self, tokens, pos, active, temp, topp, table, seeds,
                    rows):
        """``chunk`` decode steps; the chosen token feeds back on the
        device.  Returns (tokens [chunk, B], bad [chunk, B]): ``bad`` flags
        active lanes whose logits were not finite."""
        toks, bads = [], []
        tok = tokens
        for i in range(self.chunk):
            logits = self._decode_one(tok, pos + i, active, table)
            bads.append(active & ~torch.isfinite(logits).all(dim=-1))
            tok = self._sample_tokens(logits, pos + i, temp, topp, seeds,
                                      rows)
            toks.append(tok)
        self.last_logits = logits
        return torch.stack(toks), torch.stack(bads)

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
        cfg = self.cfg
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
                                    attend_fn=attend_fn)
        return x

    def _mixed_impl(self, tokens, pos, active, q_lens, temp, topp, seeds,
                    table, rows):
        """One mixed prefill/decode step: decode-ready slots ride as
        ``q_lens == 1`` lanes, prefilling slots carry a chunk of their
        prompt.  ONLY each slot's last live row goes through the lm_head;
        its token is drawn with the (seed, pos + q_lens - 1) key the plain
        decode step uses at that position, so a decode lane's token and a
        completing prefill's first token are the bucketed engine's.
        Returns (next token [B], bad [B]: active lanes whose emit logits
        were not finite)."""
        B = self.max_batch
        x = self._rows_forward(tokens, pos, active, q_lens, table,
                               verify=False)
        last = x[torch.arange(B, device=self.device), q_lens - 1]
        logits = lm_head_logits(self.cfg, self.params, last)      # [B, V]
        self.last_logits = logits
        bad = active & ~torch.isfinite(logits).all(dim=-1)
        nxt = self._sample_tokens(logits, pos + q_lens - 1, temp, topp,
                                  seeds, rows)
        return nxt, bad

    def _verify_impl(self, tokens, pos, active, q_lens, temp, topp, seeds,
                     table, rows):
        """Verify + accept in one step.  tokens [B, Q]: row 0 the pending
        token, rows 1.. the drafts.  Row t's token is drawn with the key
        (seed, pos + t) the plain decode step would use there, so row 0's
        token is what plain decode produces and a draft is accepted exactly
        when it equals the token chosen one row earlier: the accepted
        stream is token-identical to the speculation-off engine.  ``rows``
        are the sampled lanes.  Returns (out [B, Q] chosen tokens,
        n_emitted [B] in 1..q_lens: the leading run of accepted drafts + the
        correction token, bad [B]: active lanes with a non-finite live
        row)."""
        B, Q = tokens.shape
        dev = self.device
        x = self._rows_forward(tokens, pos, active, q_lens, table,
                               verify=True)
        logits = lm_head_logits(self.cfg, self.params, x)         # [B, Q, V]
        self.last_logits = logits[:, 0]
        t = torch.arange(Q, device=dev)
        live = t[None, :] < q_lens[:, None]
        bad = active & (~torch.isfinite(logits).all(dim=-1) & live).any(-1)
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

    def _prefill_body(self, ids, length, bucket, write):
        """Embed/rope/mask once, the paged write path injected.  Tokens at
        or beyond ``length`` are padding, masked out of attention.  No
        logits: the last prompt token is fed to the first decode step."""
        cfg = self.cfg
        S = self.max_seq
        x = self.params["embed"][ids].to(cfg.dtype)
        cos = self._cos[:, :bucket]
        sin = self._sin[:, :bucket]
        q_pos = torch.arange(bucket, device=self.device)[None, None, None, :,
                                                         None]
        kv_pos = torch.arange(S, device=self.device)[None, None, None, None, :]
        mask = (kv_pos <= q_pos) & (kv_pos < length)
        transformer_apply(cfg, self.params, x, self.cache_k, self.cache_v,
                          write, mask, cos, sin)

    def _prefill_impl_paged(self, ids, table_row, length, bucket):
        """Prefill into the slot's pages: prompt position j writes page
        table_row[j // bs] offset j % bs.  fp pools: padding positions on
        unallocated (sentinel) pages land on the spill page, masked from
        attention.  Quantized pools requantize each dirty page once, PAD
        rows (j >= length) masked out: a garbage pad row in the prompt's
        tail page would inflate that page's scale and coarsen its real
        rows' codes for good."""
        cfg = self.cfg
        S, bs = self.max_seq, self.block_size
        nkv, hd = cfg.num_key_value_heads, cfg.head_dim
        j = torch.arange(bucket, device=self.device)
        row = table_row.long()

        if self.kv_quant is not None:
            write = self._quant_rows_write(table_row[None], j[None],
                                           ((j < length) & (j < S))[None])
        else:
            blk_j = row[j // bs]
            off_j = j % bs

            def write(ck, k):
                # k [1, bucket, nkv, hd] -> each position into its page (in
                # place); view = this slot's gathered pages, batch 1
                ck[blk_j, :, off_j] = k[0]
                view = ck[row].transpose(0, 1).reshape(1, nkv, S, hd)
                return ck, view

        self._prefill_body(ids, length, bucket, write)

    def _quant_rows_write(self, table, row_pos, valid, view=True):
        """write_fn for a multi-row event into quantized pools: the
        page-batched requantize (``quant_append_rows``: only dirty pages
        change), then what attention reads.  A prefill bucket
        (``view=True``) reads a dequantized gather of the slot's pages in
        the model dtype (batch 1); sentinel entries read the spill page,
        whose codes and scale stay zero, so they read as zeros like the
        reference's fill.  The mixed and verify steps (``view=False``) read
        the pools themselves through the paged walks."""
        cfg = self.cfg
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
        """Grow slot to n_blocks pages; False if the pool runs dry."""
        owned = self._slot_blocks[slot]
        while len(owned) < n_blocks:
            if not self._free:
                return False
            b = self._free.pop()
            self._table[slot, len(owned)] = b
            owned.append(b)
        return True

    def _release(self, slot: int):
        self._free.extend(self._slot_blocks[slot])
        self._slot_blocks[slot] = []
        self._table[slot, :] = self.num_blocks

    def _preempt(self, slot: int):
        """Recompute preemption: free the slot, requeue the request with
        prompt + generated-so-far at the head of the queue, keeping its
        seniority.  Resume teacher-forces the stored tokens, and sampled
        draws are keyed by (seed, position), so the stream continues
        exactly."""
        req = self._slot_req[slot]
        req._resume_ids = np.concatenate(
            [np.asarray(req.prompt_ids, np.int32).ravel(),
             np.asarray(req.output_ids, np.int32)])
        req._resume_age = int(self._slot_age[slot])
        self._release(slot)
        self._slot_req[slot] = None
        self._temp[slot] = 0.0  # re-set on readmission
        if self._chunked:
            # a mid-prefill victim resumes as a fresh admission
            self._prefill_ids[slot] = None
            self._prefilled[slot] = 0
        req.status = "PENDING"
        self._queue.insert(0, req)
        self.stats["preemptions"] += 1

    def _ensure_growth(self, k):
        """Before a step: every active slot needs pages covering positions
        up to pos+k-1 (``k`` may be a per-slot vector: the verify step
        appends q_lens rows to each slot and the mixed step a chunk or one
        token).  Oldest slots win; when the pool is dry the youngest other
        active slot is preempted."""
        karr = np.broadcast_to(np.asarray(k, np.int64), (self.max_batch,))
        order = sorted((s for s in range(self.max_batch)
                        if self._slot_req[s] is not None),
                       key=lambda s: self._slot_age[s])
        for slot in order:
            if self._slot_req[slot] is None:
                continue  # preempted by an older slot this pass
            need = self._blocks_needed(int(self._pos[slot])
                                       + int(karr[slot]) - 1)
            while not self._alloc_to(slot, need):
                victims = [s for s in range(self.max_batch)
                           if s != slot and self._slot_req[s] is not None]
                if not victims:
                    req = self._slot_req[slot]
                    raise RuntimeError(
                        f"KV block pool exhausted by a single request: "
                        f"rid={req.rid} needs {need} block(s) "
                        f"({len(self._slot_blocks[slot])} mapped, "
                        f"{len(self._free)} free, {self.num_blocks} total); "
                        f"increase num_blocks")
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

    def add_request(self, req: Request):
        self._validate(req)
        req.prompt_ids = np.asarray(req.prompt_ids, np.int32).ravel()
        req._submit_s = time.perf_counter()  # TTFT epoch
        self._queue.append(req)

    def _admit(self):
        """Fill free slots from the queue: a request enters only when its
        prompt's pages, plus the resident slots' imminent growth (the next
        decode chunk, or a verify step's K+1 rows), fit in the free pool.
        A bucketed admission prefills its whole prompt now (stalling the
        resident slots' decode for it); a chunked one only enqueues the
        prompt for the mixed steps to stream."""
        for slot in range(self.max_batch):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            req = self._queue[0]
            ids = getattr(req, "_resume_ids", None)
            if ids is None:
                ids = np.asarray(req.prompt_ids, np.int32).ravel()
            s0 = ids.size
            horizon = max(self.chunk, self._spec_qmax)
            # per-slot clamp at 0: a mid-prefill slot owns its whole
            # prompt's pages while pos (its cursor) trails them
            headroom = sum(
                max(0, self._blocks_needed(int(self._pos[s]) + horizon - 1)
                    - len(self._slot_blocks[s]))
                for s in range(self.max_batch)
                if self._slot_req[s] is not None)
            need = self._blocks_needed(s0 - 1)
            gate = self._blocks_needed(s0 - 2 + horizon)
            if (len(self._free) < gate + headroom
                    or not self._alloc_to(slot, need)):
                self._release(slot)
                break  # pool dry: keep queue order, retry next step
            age = getattr(req, "_resume_age", None)
            self._slot_age[slot] = self._admit_seq if age is None else age
            self._admit_seq += 1
            self._queue.pop(0)
            for attr in ("_resume_ids", "_resume_age"):
                if hasattr(req, attr):
                    delattr(req, attr)
            if self._chunked:
                # enqueue without prefill: the mixed steps stream positions
                # [0, s0), and the last one (the last prompt token) emits
                # the first generated token
                self._prefill_ids[slot] = ids
                self._prefilled[slot] = 0
                self._pos[slot] = 0
            else:
                # a whole-prompt prefill while other slots are seated
                # stalls their decode for the prompt's length
                stalls = any(r is not None for r in self._slot_req)
                bucket = min(_bucket(s0), self.max_seq)
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :s0] = ids
                t_pf = time.perf_counter()
                # the last real token is fed to decode, not prefill
                self._prefill_impl_paged(
                    torch.as_tensor(padded, device=self.device).long(),
                    torch.as_tensor(self._table[slot], device=self.device),
                    s0 - 1, bucket)
                self._sync()
                self.stats["prefill_time_s"] += time.perf_counter() - t_pf
                self.stats["prefills"] += 1
                self.stats["decode_stall_steps"] += int(stalls)
                self._pos[slot] = s0 - 1
            self._slot_req[slot] = req
            req.status = "RUNNING"
            self._last_tok[slot] = ids[-1]
            self._temp[slot] = max(float(req.temperature or 0.0), 0.0)
            self._topp[slot] = float(req.top_p if req.top_p is not None
                                     else 1.0)
            # default seed: the request id, so two concurrent sampled
            # requests never share a stream
            self._seed[slot] = np.int32(
                req.seed if req.seed is not None else req.rid)

    def _retire(self, slot):
        req = self._slot_req[slot]
        req.status = "FINISHED"
        req.finished = True
        self._slot_req[slot] = None
        self._temp[slot] = 0.0
        if self._chunked:
            self._prefill_ids[slot] = None
            self._prefilled[slot] = 0
        self._release(slot)

    def step(self) -> bool:
        """One admit + device iteration with one host fetch: while any
        prompt streams in (chunked prefill), ONE mixed prefill/decode step;
        else, with speculation on and at least one slot drafting, ONE
        multi-token verify step; else ``chunk`` decode steps.  Returns False
        when idle."""
        self._admit()
        if self._chunked and any(i is not None for i in self._prefill_ids):
            return self._mixed_step()
        if self._spec is not None:
            drafts = self._draft_proposals()
            if drafts is not None:
                return self._spec_step(drafts)
            # no slot drafted: the ordinary decode path, at no extra cost
        k = self.chunk
        self._ensure_growth(k)  # may preempt the youngest slot
        active_np = np.asarray([r is not None for r in self._slot_req])
        if not active_np.any():
            return False
        t0 = time.perf_counter()
        dev = self.device
        sampled_lanes = [s for s in range(self.max_batch)
                         if active_np[s] and self._temp[s] > 0]
        toks, bad = self._chunk_scan(
            torch.as_tensor(self._last_tok, device=dev).long(),
            torch.as_tensor(self._pos, device=dev).long(),
            torch.as_tensor(active_np, device=dev),
            torch.as_tensor(self._temp, device=dev),
            torch.as_tensor(self._topp, device=dev),
            torch.as_tensor(self._table, device=dev),
            torch.as_tensor(self._seed, device=dev),
            torch.as_tensor(sampled_lanes, dtype=torch.long, device=dev)
            if sampled_lanes else None)
        # ONE host round-trip per chunk: tokens and guard flags together
        fetched = torch.cat([toks, bad.long()]).cpu().numpy()
        toks_np, bad_np = fetched[:k], fetched[k:]
        self.stats["decode_time_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += k
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            old_pos = int(self._pos[slot])
            # tokens produced from positions >= max_seq are garbage (their
            # K/V writes were dropped)
            valid = min(k, self.max_seq - old_pos)
            if bad_np[:valid, slot].any():
                raise FloatingPointError(
                    f"non-finite logits for rid={req.rid} at positions "
                    f"{old_pos}..{old_pos + valid - 1}")
            done = False
            for j in range(valid):
                tok = int(toks_np[j, slot])
                req.output_ids.append(tok)
                if req.ttft_s is None:
                    req.ttft_s = time.perf_counter() - req._submit_s
                self.stats["decode_tokens"] += 1
                if (len(req.output_ids) >= req.max_new_tokens
                        or (req.eos_token_id is not None
                            and tok == req.eos_token_id)):
                    done = True
                    break
            self._pos[slot] = old_pos + k  # device advanced k regardless
            self._last_tok[slot] = int(toks_np[-1, slot])
            if done or old_pos + k >= self.max_seq:
                self._retire(slot)
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
        with a one-row floor.  A lane whose chunk reaches its last prompt
        token consumes the emitted token (its first generated token);
        mid-prompt lanes ignore theirs.  One host fetch."""
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
        for s in prefilling:
            ids = self._prefill_ids[s]
            cur = int(self._prefilled[s])
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
        self._ensure_growth(growth)  # may preempt the youngest slot
        for s in range(B):
            if self._slot_req[s] is None:       # preempted after packing
                active[s] = False
                chunk_rows.pop(s, None)
        if not active.any():
            return bool(self._queue)
        t0 = time.perf_counter()
        dev = self.device
        nxt, bad = self._mixed_impl(
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(pos, device=dev).long(),
            torch.as_tensor(active, device=dev),
            torch.as_tensor(q_lens, device=dev).long(),
            *self._device_args(active))
        # ONE host round-trip: the tokens and the guard flags together
        nxt_np, bad_np = torch.stack([nxt, bad.long()]).cpu().numpy()
        self.stats["decode_time_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["mixed_steps"] += 1
        self.stats["prefill_chunks"] += len(chunk_rows)
        if bad_np.any():
            s = int(np.flatnonzero(bad_np)[0])
            raise FloatingPointError(
                f"non-finite logits for rid={self._slot_req[s].rid} in a "
                f"mixed step (row-0 position {int(pos[s])})")
        for s in decode_slots:
            req = self._slot_req[s]
            if req is None:
                continue            # preempted by _ensure_growth
            old_pos = int(self._pos[s])
            self._pos[s] = old_pos + 1
            self._consume_token(s, req, int(nxt_np[s]))
            if self._slot_req[s] is not None and old_pos + 1 >= self.max_seq:
                self._retire(s)
        for s, n in chunk_rows.items():
            req = self._slot_req[s]
            ids = self._prefill_ids[s]
            new_cur = int(self._prefilled[s]) + n
            self._prefilled[s] = new_cur
            self._pos[s] = new_cur
            if new_cur >= ids.size:
                # final chunk: its emit row sat at the last prompt token
                self._prefill_ids[s] = None
                self._prefilled[s] = 0
                self._consume_token(s, req, int(nxt_np[s]))
                if self._slot_req[s] is not None and new_cur >= self.max_seq:
                    self._retire(s)
        return True

    def _consume_token(self, slot: int, req: Request, tok: int):
        """Bank one generated token (a mixed-step emit, or one of a verify
        step's accepted run): append, stamp TTFT, count it, feed it back,
        retire on EOS or the token budget."""
        req.output_ids.append(tok)
        if req.ttft_s is None:
            req.ttft_s = time.perf_counter() - req._submit_s
        self.stats["decode_tokens"] += 1
        self._last_tok[slot] = tok
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
        in their page's requantize, as in the reference)."""
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
        dev = self.device
        out, n_acc, bad = self._verify_impl(
            torch.as_tensor(tokens, device=dev).long(),
            torch.as_tensor(self._pos, device=dev).long(),
            torch.as_tensor(active_np, device=dev),
            torch.as_tensor(q_lens, device=dev).long(),
            *self._device_args(active_np))
        # ONE host round-trip: tokens, accepted counts and guard flags
        fetched = torch.cat([out, n_acc[:, None], bad.long()[:, None]],
                            dim=1).cpu().numpy()
        out_np, n_np, bad_np = fetched[:, :Q], fetched[:, Q], fetched[:, Q + 1]
        self.stats["decode_time_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        if bad_np.any():
            s = int(np.flatnonzero(bad_np)[0])
            raise FloatingPointError(
                f"non-finite logits for rid={self._slot_req[s].rid} in a "
                f"verify step at positions {int(self._pos[s])}.."
                f"{int(self._pos[s]) + int(q_lens[s]) - 1}")
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            old_pos = int(self._pos[slot])
            n = int(n_np[slot])        # 1..q_lens: accepted run + correction
            drafted = int(q_lens[slot]) - 1
            self.stats["spec_drafted_tokens"] += drafted
            self.stats["spec_accepted_tokens"] += n - 1
            self.stats["spec_rejected_tokens"] += drafted - (n - 1)
            for j in range(n):
                self._consume_token(slot, req, int(out_np[slot, j]))
                if self._slot_req[slot] is None:
                    break           # EOS or the token budget: retired
            else:
                self._pos[slot] = old_pos + n
                if old_pos + n >= self.max_seq:
                    self._retire(slot)
        return True

    @property
    def spec_acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verify step accepted (0.0 before
        any speculative step, and with speculation off)."""
        d = self.stats["spec_drafted_tokens"]
        return self.stats["spec_accepted_tokens"] / d if d > 0 else 0.0

    def serve(self, requests: list[Request]) -> dict[int, list[int]]:
        """Run all requests to completion; returns {rid: generated tokens}.
        Validation is all-or-nothing: any bad request raises before
        anything is enqueued."""
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
