"""Continuous-batching serving engine, paged subset (counterpart of
``paddle_tpu/inference/serving.py``).

Ported: ``Request``, ``_bucket`` and the ``ContinuousBatchingEngine`` path
``serve`` -> ``add_request`` -> ``step`` -> ``_admit`` ->
``_prefill_impl_paged`` -> ``_decode_one`` -> ``_sample_tokens``, with
its block allocator (``_alloc_to``, ``_release``), preemption
(``_preempt``, ``_ensure_growth``) and retirement; fp or quantized KV
pools (``kv_quant``); and the three decode arms of ``_decode_one``: the
fused step (one kernel a layer, fp or quantized pools), and the unfused
arm the ``fused_decode_step`` / ``fused_quant_append`` switches rebuild the
engine on (an append, then the paged decode attention).  Not ported yet
(ROADMAP.md): the dense-cache mode, prefix cache, speculation, chunked
prefill, weight-only quant, tensor parallelism, the graceful fault ladder,
metrics, the journal and async host runtime, snapshot/restore and the
fleet.  Invalid requests therefore raise (the reference's
``PADDLE_TPU_GRACEFUL=0`` contract).

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
import time
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
    """

    def __init__(self, cfg, params, max_batch: int = 8, max_seq: int = 512,
                 chunk: int = 1, block_size: int = 64,
                 num_blocks: int | None = None, kv_quant: str | None = None,
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
        self.stats = {"decode_steps": 0, "decode_tokens": 0,
                      "decode_time_s": 0.0, "prefills": 0,
                      "prefill_time_s": 0.0, "preemptions": 0}
        #: logits [B, V] of the last decode step run (inspection only)
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

    def _quant_rows_write(self, table, row_pos, valid):
        """write_fn for a multi-row event (a prefill bucket) into quantized
        pools: the page-batched requantize (``quant_append_rows``: only
        dirty pages rewrite), then the dense attend's view, a dequantized
        gather of the slot's pages in the model dtype (batch 1).  Sentinel
        entries read the spill page, whose codes and scale stay zero, so
        they read as zeros like the reference's fill."""
        cfg = self.cfg
        S = self.max_seq
        nkv, hd = cfg.num_key_value_heads, cfg.head_dim
        kvq = self.kv_quant
        pages = table[0].long()

        def write(ck, k):
            _pa.quant_append_rows(ck["q"], ck["scale"], k, table, row_pos,
                                  valid, kvq)
            view = _pa._dequant_page_content(ck["q"][pages],
                                             ck["scale"][pages], kvq)
            view = view.transpose(0, 1).reshape(1, nkv, S, hd)
            return ck, view.to(cfg.dtype)

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
        req.status = "PENDING"
        self._queue.insert(0, req)
        self.stats["preemptions"] += 1

    def _ensure_growth(self, k: int):
        """Before a decode chunk: every active slot needs pages covering
        positions up to pos+k-1.  Oldest slots win; when the pool is dry
        the youngest other active slot is preempted."""
        order = sorted((s for s in range(self.max_batch)
                        if self._slot_req[s] is not None),
                       key=lambda s: self._slot_age[s])
        for slot in order:
            if self._slot_req[slot] is None:
                continue  # preempted by an older slot this pass
            need = self._blocks_needed(int(self._pos[slot]) + k - 1)
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
        prompt's pages, plus the resident slots' next-chunk growth, fit in
        the free pool.  Each admission prefills its whole prompt."""
        for slot in range(self.max_batch):
            if self._slot_req[slot] is not None or not self._queue:
                continue
            req = self._queue[0]
            ids = getattr(req, "_resume_ids", None)
            if ids is None:
                ids = np.asarray(req.prompt_ids, np.int32).ravel()
            s0 = ids.size
            horizon = self.chunk
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
            self._slot_req[slot] = req
            req.status = "RUNNING"
            self._pos[slot] = s0 - 1
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
        self._release(slot)

    def step(self) -> bool:
        """One admit + decode iteration (``chunk`` decode steps, one host
        fetch).  Returns False when idle."""
        self._admit()
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
