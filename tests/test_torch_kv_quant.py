"""The port's KV-quantized serving slice and unfused decode arms against the
JAX package on the CPU.

The JAX side runs as its own tests run it here: Pallas in interpret mode,
and its XLA helpers compiled with ``jax.jit`` as its engine compiles them
(XLA turns the encode's division by the constant bound into a multiply by
the f32 reciprocal, and the port stores what the compiled engine stores).
The port's side runs its plain PyTorch versions (CPU tensors always take
them; ``chip_smoke.py`` and ``test_torch_cuda.py`` hold the CUDA kernels
against these on the card).  Inputs are f32, made with numpy from a seed,
handed to both.  Codes and scales of quantized pools compare EXACTLY (both
sides run the same f32 operations, each correctly rounded, and round half
to even); attention outputs at atol = rtol = 1e-5 (sums in other orders).

- the storage helpers (``quantize_kv_cache``, ``_quant_encode_page``, the
  int4 nibble layout, the dequantizers);
- the requantized appends, a reused page's stale rows included;
- ``paged_attention_decode`` over fp, int8 and int4 pools on the split-K
  and the sequential route (a zero-length lane, sentinel table entries);
- ``fused_quant_decode_step`` for int8 and int4: output, codes, scales,
  and the spill page a dropped lane zeroes;
- the engine with ``kv_quant`` int8 and int4: greedy and seeded streams,
  and the pools' codes and scales, equal to the JAX engine's across a
  preemption; the fused, kill-switched and gather-oracle arms emit the same
  tokens; the fp engine rebuilt on its unfused arm matches the JAX engine
  rebuilt the same way; ``kv_quant`` is validated.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.inference.serving import ContinuousBatchingEngine, Request
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.utils.convert import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
JAX_ENV, TORCH_ENV = "PADDLE_TPU_DISABLE_PALLAS", "PADDLE_TPU_TORCH_DISABLE_KERNELS"
f32 = np.float32


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _jit(fn, mode):
    """A JAX helper compiled as the engine compiles it, for one mode."""
    return jax.jit(functools.partial(fn, **{
        "quantize_kv_cache": {"mode": mode},
        "dequantize_kv_cache": {"mode": mode}}.get(fn.__name__,
                                                   {"kv_quant": mode})))


def _random_codes(rs, shape, mode):
    """A pool that already holds codes (stale rows of earlier owners)."""
    if mode == "int8":
        return rs.randint(-127, 128, size=shape).astype(np.int8)
    return rs.randint(-128, 128, size=shape[:-1] + (shape[-1] // 2,)) \
        .astype(np.int8)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_storage_helpers_match_jax(mode):
    """Codes and scales exact: an all-zero page (scale 0, codes 0), exact
    halves (half to even), and for int4 the nibble layout (element 2i in
    the low nibble, 2i+1 in the high one, sign-extended)."""
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 2, 8, 16) * 2).astype(f32)
    x[0, 1] = 0
    bound = 127.0 if mode == "int8" else 7.0
    x[2, 0] = rs.randint(-6, 7, size=(8, 16)) + 0.5   # scale 1: exact halves
    x[2, 0, 0, 0] = bound
    jq, js = _jit(jpa.quantize_kv_cache, mode)(jnp.asarray(x))
    tq, ts = tpa.quantize_kv_cache(torch.from_numpy(x), mode)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[2, 0].item() == 1.0 and ts[0, 1].item() == 0.0
    content = x.reshape(3, 2, 8, 16)[None]                 # [1, ...] pages
    jc, jsc = _jit(jpa._quant_encode_page, mode)(jnp.asarray(content))
    tc, tsc = tpa._quant_encode_page(torch.from_numpy(content), mode)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        tpa.dequantize_kv_cache(tq, ts, mode).numpy(),
        np.asarray(_jit(jpa.dequantize_kv_cache, mode)(jq, js)))
    np.testing.assert_array_equal(
        tpa._dequant_page_content(tc, tsc, mode).numpy(),
        np.asarray(_jit(jpa._dequant_page_content, mode)(jc, jsc)))
    if mode == "int4":
        # byte 0x9F: low nibble 0xF = -1 (element 0), high 0x9 = -7
        packed = torch.tensor([[np.int8(-97), np.int8(0x71)]])
        assert tpa._unpack_int4(packed).tolist() == [[-1.0, -7.0, 1.0, 7.0]]
        np.testing.assert_array_equal(
            tpa._unpack_int4(packed).numpy(),
            np.asarray(jax.jit(jpa._unpack_int4)(jnp.asarray(
                packed.numpy(), jnp.int32))))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quant_appends_match_jax(mode):
    """Single-row and multi-row requantized appends, exact: pages of random
    stale codes (their rows decide the new absmax), a dropped lane, clean
    pages untouched, in place."""
    rs = np.random.RandomState(1)
    nbp, nkv, bs, hd = 7, 2, 8, 16
    pool = _random_codes(rs, (nbp, nkv, bs, hd), mode)
    scale = rs.rand(nbp, nkv).astype(f32) * 0.1
    rows = rs.randn(4, nkv, hd).astype(f32)
    blk = np.array([1, 3, 5, 2], np.int32)
    off = np.array([0, 7, 3, 4], np.int32)
    wable = np.array([1, 1, 0, 1], np.int32)
    jq, js = _jit(jpa.quant_append_decode, mode)(
        *map(_j, (pool, scale, rows, blk, off, wable)))
    tq, ts = _t(pool), _t(scale)
    out = tpa.quant_append_decode(tq, ts, *map(_t, (rows, blk, off, wable)),
                                  mode)
    assert out[0].data_ptr() == tq.data_ptr(), "in place"
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    clean = [p for p in range(nbp) if p not in (1, 3, 2)]
    np.testing.assert_array_equal(tq.numpy()[clean], pool[clean])
    # a prefill event: slot 0 writes positions 3..14 (pages 0-1 of its
    # row), slot 1 its first 5 positions of a 12-row bucket; sentinels nbp
    table = np.array([[4, 0, nbp, nbp], [6, 1, nbp, nbp]], np.int32)
    rows2 = rs.randn(2, 12, nkv, hd).astype(f32)
    pos = np.stack([np.arange(3, 15), np.arange(12)]).astype(np.int32)
    valid = np.stack([np.ones(12, bool), np.arange(12) < 5])
    jq2, js2 = _jit(jpa.quant_append_rows, mode)(
        *map(_j, (pool, scale, rows2, table, pos, valid)))
    tq2, ts2 = _t(pool), _t(scale)
    tpa.quant_append_rows(tq2, ts2, *map(_t, (rows2, table, pos, valid)),
                          mode)
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))
    clean = [p for p in range(nbp) if p not in (4, 0, 6)]
    np.testing.assert_array_equal(tq2.numpy()[clean], pool[clean])
    np.testing.assert_array_equal(ts2.numpy()[clean], scale[clean])


def _decode_case(mode, rs):
    """3 lanes, block 8, table width 8, a 20-page pool: lane 0 has length 0
    (its table all one page), lane 1 the full 64 positions, lane 2 13
    positions with sentinel entries (20, past the pool) after its pages."""
    b, nh, nkv, hd, bs, mb, nb = 3, 2, 1, 16, 8, 8, 20
    q = rs.randn(b, nh, hd).astype(f32)
    kc = rs.randn(nb, nkv, bs, hd).astype(f32)
    vc = rs.randn(nb, nkv, bs, hd).astype(f32)
    ks = vs = None
    if mode:
        enc = _jit(jpa.quantize_kv_cache, mode)
        kc, ks = (np.asarray(a) for a in enc(jnp.asarray(kc)))
        vc, vs = (np.asarray(a) for a in enc(jnp.asarray(vc)))
    perm = rs.permutation(nb).astype(np.int32)
    tables = np.full((b, mb), nb, np.int32)
    tables[0] = perm[10]
    tables[1] = perm[:8]
    tables[2, :2] = perm[8:10]
    lens = np.array([0, 64, 13], np.int32)
    return q, kc, vc, tables, lens, ks, vs


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_paged_attention_decode_matches_pallas(mode):
    """The JAX split-K kernel at 4 shards (more than lane 2's live pages:
    empty shards emit the empty partial) against the port's three routes:
    num_shards None (the split-K plain version at S = 2), 4 (S = 4) and 1
    (the sequential route, whose plain version is the gather oracle).  The
    zero-length lane is exactly 0."""
    q, kc, vc, tables, lens, ks, vs = _decode_case(mode,
                                                   np.random.RandomState(2))
    want = np.asarray(jpa.paged_attention_decode(
        *map(_j, (q, kc, vc, tables, lens)), kv_quant=mode, k_scale=_j(ks),
        v_scale=_j(vs), num_shards=4))
    for num_shards, route in ((None, "flash_decode"), (4, "flash_decode"),
                              (1, "paged_decode")):
        tk.reset_counters()
        got = tda.paged_decode_attention(*map(_t, (q, kc, vc, tables, lens)),
                                         kv_quant=mode, k_scale=_t(ks),
                                         v_scale=_t(vs),
                                         num_shards=num_shards)
        assert tk.PLAIN_CALLS[route] == 1 and sum(tk.PLAIN_CALLS.values()) == 1
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert (got[0] == 0).all()


def test_paged_attention_decode_sequential_kernel_and_switches(monkeypatch):
    """The JAX sequential kernel (num_shards=1) against the port's
    sequential route; the ``flash_decode`` switch takes the split-K route
    to the sequential one and ``paged_attention`` to the gather oracle,
    in the port as in the reference."""
    q, kc, vc, tables, lens, ks, vs = _decode_case("int8",
                                                   np.random.RandomState(3))
    args = (q, kc, vc, tables, lens)
    kw = dict(kv_quant="int8")
    want = np.asarray(jpa.paged_attention_decode(
        *map(_j, args), k_scale=_j(ks), v_scale=_j(vs), num_shards=1, **kw))
    for token, route in ((None, "flash_decode"), ("flash_decode",
                                                  "paged_decode"),
                         ("paged_attention", "paged_decode")):
        if token:
            monkeypatch.setenv(TORCH_ENV, token)
        tk.reset_counters()
        got = tda.paged_decode_attention(*map(_t, args), k_scale=_t(ks),
                                         v_scale=_t(vs), **kw)
        assert tk.PLAIN_CALLS[route] == 1
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    oracle = tpa.paged_attention_reference(*map(_t, args), k_scale=_t(ks),
                                           v_scale=_t(vs), **kw)
    assert torch.equal(got, oracle)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_fused_quant_decode_step_matches_pallas(mode):
    """Output, both code pools and both scale vectors: the requantized
    write pages (stale rows decide the scale), the untouched pages, and the
    spill page the dropped lane zeroes (it starts non-zero).  Lanes as the
    fp fused test's: an append at position 0, one at a page boundary, one
    mid-page, one dropped.  The v pool is exact; the k pool is held within
    2^-22 relative on the scales and one code step (the port's f32 rope is
    the reference's FMA, and ``test_requantize_matches_jax_exactly`` holds
    the k side bit for bit)."""
    rs = np.random.RandomState(4)
    b, nh, nkv, hd, bs, mb, nb = 4, 2, 1, 16, 8, 4, 12
    nbp = nb + 1
    q = rs.randn(b, nh, hd).astype(f32)
    k_new = rs.randn(b, nkv, hd).astype(f32)
    v_new = rs.randn(b, nkv, hd).astype(f32)
    ang = rs.rand(b, hd // 2).astype(f32) * 3
    ang = np.concatenate([ang, ang], -1)
    cos, sin = np.cos(ang).astype(f32), np.sin(ang).astype(f32)
    kq = _random_codes(rs, (nbp, nkv, bs, hd), mode)
    vq = _random_codes(rs, (nbp, nkv, bs, hd), mode)
    ksc = (rs.rand(nbp, nkv) * 0.05).astype(f32)
    vsc = (rs.rand(nbp, nkv) * 0.05).astype(f32)
    tables = np.full((b, mb), nb, np.int32)
    tables[0, :1] = [7]
    tables[1, :2] = [3, 9]
    tables[2, :2] = [0, 5]
    lens = np.array([0, 8, 13, 0], np.int32)
    wable = np.array([1, 1, 1, 0], np.int32)
    wblk = np.array([7, 9, 5, nb], np.int32)
    case = (q, k_new, v_new, cos, sin, kq, ksc, vq, vsc, tables, lens, wblk,
            wable)
    jo, jkq, jks, jvq, jvs = jpa.fused_quant_decode_step(*map(_j, case), mode)
    tcase = [_t(a) for a in case]
    tk.reset_counters()
    to, tkq, tks, tvq, tvs = tda.fused_paged_quant_decode_step(*tcase, mode)
    assert tk.PLAIN_CALLS["fused_quant_decode_step"] == 1
    assert tkq.data_ptr() == tcase[5].data_ptr(), "codes updated in place"
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_array_equal(tvq.numpy(), np.asarray(jvq))
    np.testing.assert_array_equal(tvs.numpy(), np.asarray(jvs))
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), rtol=2.0 ** -22,
                               atol=0)
    codes = lambda c: tpa._unpack_int4(c) if mode == "int4" else c.float()
    assert (codes(tkq) - codes(_t(jkq))).abs().max() <= 1
    assert (tkq[nb] == 0).all() and (tks[nb] == 0).all()
    untouched = [p for p in range(nb) if p not in (7, 9, 5)]
    np.testing.assert_array_equal(tkq.numpy()[untouched], kq[untouched])


def _pack_codes(c, mode):
    """Integer codes [..., hd] -> the pool's int8 storage."""
    if mode == "int8":
        return c.astype(np.int8)
    return ((c[..., 0::2] & 0xF) | ((c[..., 1::2] & 0xF) << 4)).astype(np.int8)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_requantize_matches_jax_exactly(mode):
    """The requantized append where the engines' int4 pools once parted,
    held bit for bit against the JAX package on equal inputs: the fused
    decode step (its Pallas kernel in interpret mode, and its XLA
    composition compiled with ``jax.jit``) against the port's plain
    version, codes and scales exactly equal.  Three write pages, built
    from a numpy seed around one appended row each:

    - lane 0, exact ties: the row overwritten held the page's only
      ``bound`` code, so the new absmax is a dequantized ``bound - 1`` code
      and every ``(bound - 1) / 2`` code requantizes to exactly
      ``bound / 2`` (3.5 for int4), which rounds half to even;
    - lane 1, near ties: the new row's absmax sits a few ulps above that
      dequantized code (rope angle 0), so the quotients fall just under the
      half;
    - lanes 2-3, the rope: large new rows hold their pages' absmax, so the
      scale is the roped row's, which the reference's compiled f32 rope
      computes as ``fma(k, cos, rot * sin)``."""
    rs = np.random.RandomState(12)
    bound = 127 if mode == "int8" else 7
    b, nh, nkv, hd, bs, mb, nb = 4, 2, 1, 32, 8, 2, 6
    nbp = nb + 1
    codes = rs.randint(-(bound - 2), bound - 1, size=(nbp, nkv, bs, hd))
    off = np.array([5, 2, 3, 6], np.int32)
    wblk = np.array([4, 1, 2, 5], np.int32)
    half = (bound - 1) // 2
    for p, o in zip(wblk[:2], off[:2]):
        page = codes[p, 0]
        page[page == half] = half - 1
        page[page == -half] = 1 - half
        page[o, 0] = bound                     # the absmax the append removes
        page[(o + 1) % bs, 1] = -(bound - 1)   # the absmax after it
        ties = rs.choice([r for r in range(bs) if r != o], 6)
        page[ties, rs.randint(2, hd, size=6)] = half * rs.choice([-1, 1], 6)
    kq = _pack_codes(codes, mode)
    vq = _random_codes(rs, (nbp, nkv, bs, hd), mode)
    ksc = (0.04 + rs.rand(nbp, nkv) * 0.03).astype(f32)
    vsc = (rs.rand(nbp, nkv) * 0.05).astype(f32)
    q = rs.randn(b, nh, hd).astype(f32)
    v_new = rs.randn(b, nkv, hd).astype(f32)
    k_new = (rs.randn(b, nkv, hd) * 0.2).astype(f32)
    ang = np.concatenate([rs.rand(b, hd // 2)] * 2, -1).astype(f32) * 3
    ang[1] = 0
    cos, sin = np.cos(ang).astype(f32), np.sin(ang).astype(f32)
    below = f32(bound - 1) * ksc[wblk[0], 0]
    k_new[0] *= f32(0.5) * below / np.abs(k_new[0]).max()
    near = f32(bound - 1) * ksc[wblk[1], 0]
    k_new[1] *= f32(0.9) * near / np.abs(k_new[1]).max()
    for _ in range(4):                         # four ulps above
        near = np.nextafter(near, f32(np.inf))
    k_new[1, 0, 7] = near
    k_new[2:] *= 30
    tables = np.full((b, mb), nb, np.int32)
    tables[:, 0] = wblk
    lens = off.copy()
    wable = np.ones(b, np.int32)
    case = (q, k_new, v_new, cos, sin, kq, ksc, vq, vsc, tables, lens, wblk,
            wable)
    want = [np.asarray(a) for a in jpa.fused_quant_decode_step(
        *map(_j, case), mode)[1:]]
    xla = [np.asarray(a) for a in jax.jit(functools.partial(
        jpa.fused_quant_decode_step_reference, kv_quant=mode))(
        *map(_j, case))[1:]]
    got = [t.numpy() for t in tda.fused_paged_quant_decode_step(
        *map(_t, case), mode)[1:]]
    for g, w, x in zip(got, want, xla):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, x)
    # the cases are what they say: lane 0's page requantized onto exact
    # ties, lane 1's scale is its new row's, lanes 2-3's the roped rows'
    new_sc = got[1][wblk, 0]
    assert new_sc[0] == f32(f32(bound - 1) * ksc[wblk[0], 0]) * f32(1 / bound)
    assert new_sc[1] > f32(f32(bound - 1) * ksc[wblk[1], 0]) * f32(1 / bound)
    assert (new_sc[2:] > ksc[wblk[2:], 0]).all()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# block 8, max_seq 64: a table of 8 pages, so the unfused arm's decode
# attention takes the split-K route (S = 2).  9 pages: three ~20-token
# prompts fill the pool at admission (3 pages each) and the youngest is
# preempted when the others grow to a fourth page
QENGINE = dict(max_batch=3, max_seq=64, chunk=2, block_size=8, num_blocks=9)


@pytest.fixture(scope="module")
def models():
    """The port's seeded tiny f32 Llama, and the same weights as a JAX
    parameter tree (the two share one layout)."""
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    tparams = tllama.init_params(tcfg, seed=0, device="cpu")
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                     tparams)
    return jcfg, jparams, tcfg, tparams


def _requests(cls):
    """A greedy and two seeded top-p requests from a numpy seed.  The
    youngest (seeded) one is preempted and resumed.  Every prefill, resume
    included, fits the 32-token bucket and a seeded lane is always seated,
    so the JAX engine compiles one prefill and one decode program."""
    rs = np.random.RandomState(5)
    lens, temps, seeds = (20, 20, 17), (0.0, 1.5, 1.5), (7, -3, 1)
    return [cls(rid=i, prompt_ids=rs.randint(1, 256, size=n).astype(np.int32),
                max_new_tokens=6, temperature=t, top_p=0.8, seed=s)
            for i, (n, t, s) in enumerate(zip(lens, temps, seeds))]


def _serve_port(tcfg, tparams, monkeypatch, token, **kw):
    if token:
        monkeypatch.setenv(TORCH_ENV, token)
    else:
        monkeypatch.delenv(TORCH_ENV, raising=False)
    eng = tserving.ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw)
    tk.reset_counters()
    return eng.serve(_requests(tserving.Request)), eng, dict(tk.PLAIN_CALLS)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quant_engine_matches_jax_and_three_arms_agree(models, mode,
                                                       monkeypatch):
    """Greedy and seeded streams equal the JAX engine's (fused arm, Pallas
    interpret) across a preemption, and so do the pools' codes over the
    first num_blocks pages, with the scales within rtol 1e-5: the port
    replays the pool's whole history, free-list order and stale rows
    included.  (The k/v rows come out of matmuls that the two frameworks
    sum in other orders, a few f32 ulps apart; a page's absmax, and so its
    scale, moves with them while its rounded codes hold.)  Then the port's
    three arms (fused; ``fused_quant_append``, the requantized append +
    split-K walk; ``paged_attention``, the gather oracle) emit the same
    tokens, each through its own decode path."""
    jcfg, jparams, tcfg, tparams = models
    monkeypatch.delenv(JAX_ENV, raising=False)
    jeng = ContinuousBatchingEngine(jcfg, jparams, paged=True, kv_quant=mode,
                                    **QENGINE)
    assert jeng._fused
    want = jeng.serve(_requests(Request))
    got, teng, calls = _serve_port(tcfg, tparams, monkeypatch, None,
                                   kv_quant=mode, **QENGINE)
    assert got == want
    assert jeng.stats["preemptions"] > 0 and teng.stats["preemptions"] > 0
    nb, L = teng.num_blocks, tcfg.num_hidden_layers
    steps = teng.stats["decode_steps"]
    assert teng._fused and teng._fused_mlp
    assert calls["fused_quant_decode_step"] == L * steps
    assert calls["fused_layer_mlp"] == L * steps
    assert calls["fused_decode_step"] == calls["flash_decode"] == 0
    for tpool, jpool in ((teng.cache_k, jeng.cache_k),
                         (teng.cache_v, jeng.cache_v)):
        # the JAX engine's {"q", "scale"} pytree through the bridge
        want = params_from_numpy(jpool, device="cpu")
        assert want["q"].dtype == torch.int8
        assert torch.equal(tpool["q"][:, :nb], want["q"][:, :nb])
        torch.testing.assert_close(tpool["scale"][:, :nb],
                                   want["scale"][:, :nb], rtol=1e-5, atol=0)
    scat, seng, scalls = _serve_port(tcfg, tparams, monkeypatch,
                                     "fused_quant_append", kv_quant=mode,
                                     **QENGINE)
    assert not seng._fused and not seng._fused_mlp
    assert scalls["flash_decode"] == L * seng.stats["decode_steps"]
    assert scalls["fused_quant_decode_step"] == 0
    gather, geng, gcalls = _serve_port(tcfg, tparams, monkeypatch,
                                       "paged_attention", kv_quant=mode,
                                       **QENGINE)
    assert not geng._fused
    assert gcalls["paged_decode"] == L * geng.stats["decode_steps"]
    assert got == scat == gather
    # the gather arm computes the fused arm's composition: same pool bytes
    assert torch.equal(geng.cache_k["q"], teng.cache_k["q"])
    assert torch.equal(geng.cache_v["scale"], teng.cache_v["scale"])


@pytest.mark.parametrize("tokens,route", [
    ("fused_decode_step", "flash_decode"),
    ("fused_decode_step,flash_decode", "paged_decode")])
def test_fp_engine_unfused_arm_matches_jax(models, tokens, route,
                                           monkeypatch):
    """The fp engine rebuilt on its unfused arm (``fused_decode_step``: a
    row scatter, then the paged decode attention's split-K route; with
    ``flash_decode`` its sequential route) is token-identical, greedy and
    seeded, to the JAX engine under the same ``PADDLE_TPU_DISABLE_PALLAS``
    tokens, across a preemption."""
    jcfg, jparams, tcfg, tparams = models
    monkeypatch.setenv(JAX_ENV, tokens)
    jeng = ContinuousBatchingEngine(jcfg, jparams, paged=True, **QENGINE)
    assert not jeng._fused
    want = jeng.serve(_requests(Request))
    got, teng, calls = _serve_port(tcfg, tparams, monkeypatch, tokens,
                                   **QENGINE)
    assert got == want
    assert jeng.stats["preemptions"] > 0 and teng.stats["preemptions"] > 0
    assert not teng._fused and not teng._fused_mlp
    L = tcfg.num_hidden_layers
    assert calls[route] == L * teng.stats["decode_steps"]
    assert calls["fused_decode_step"] == calls["fused_layer_mlp"] == 0
    assert calls["flash_decode"] + calls["paged_decode"] == calls[route]


def test_kv_quant_validation(models):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="kv_quant"):
        tserving.ContinuousBatchingEngine(tcfg, tparams, kv_quant="int2",
                                          block_size=8, device="cpu")
    odd = tllama.LlamaConfig.tiny(vocab=64, hidden=36, layers=1, heads=4,
                                  kv_heads=4, inter=32)      # head_dim 9
    assert odd.head_dim % 2 == 1
    params = tllama.init_params(odd, seed=0, device="cpu")
    with pytest.raises(ValueError, match="even head_dim"):
        tserving.ContinuousBatchingEngine(odd, params, kv_quant="int4",
                                          block_size=8, max_seq=64,
                                          device="cpu")
    q = torch.zeros(1, 4, 16)
    pool = torch.zeros(2, 2, 8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="k_scale"):
        tda.paged_decode_attention(q, pool, pool, torch.zeros(1, 1).int(),
                                   torch.ones(1).int(), kv_quant="int8")
    with pytest.raises(ValueError, match="does not store"):
        tda.paged_decode_attention(q, pool, pool, torch.zeros(1, 1).int(),
                                   torch.ones(1).int(), kv_quant="int4",
                                   k_scale=torch.ones(2, 2),
                                   v_scale=torch.ones(2, 2))
