"""The port's hybrid-parallel Llama train step against the reference's on
the CPU: ``build_train_step(cfg, make_mesh(...))`` over the reference's
axes dp / sharding / mp / sep, ring and Ulysses attention.

A tiny f32 Llama (``LlamaConfig.tiny``: vocabulary 256, hidden 64, 2
layers, 4 heads over 2 kv heads, ffn 128), every leaf drawn with numpy
from a seed, one batch of 4 x 32 tokens.  The port runs as four gloo
ranks, one ``torch.multiprocessing.spawn`` for the module (a file store
under the module's tmp dir), started before the parent runs the JAX
references on the conftest's host devices (``devices()[:4]``, so rank r
is device r); the ranks import this module, so it imports JAX only inside
the functions the parent runs.  Each rank runs every case and writes what
it saw with ``torch.save``.  The reference runs its flash attention and
RMSNorm through their plain references (``PADDLE_TPU_DISABLE_PALLAS``),
the port its plain versions.

The meshes (:data:`MESHES`): dp=2 x mp=2; sharding=2 x mp=2 under
``PADDLE_TPU_XENT_CHUNK=8`` (the chunked vocab-parallel loss); mp=4 with
tied embeddings (K/V replicated over mp, the head read from the
vocab-parallel ``embed``); sep=2 x dp=2 ring; sep=2 x mp=2 Ulysses (one
kv head a rank, fewer than the sep ranks: the repeat branch); sep=4 ring
(causal blocks wholly masked).  Held to the reference, two steps from the
same weights:

- each rank's first shards equal the reference's device shards of
  ``device_put(params, param_shardings)`` bit for bit;
- loss and gnorm after each step (atol = rtol = 1e-5);
- every rank's shard of every parameter and every ``m`` / ``v`` /
  ``master`` leaf after step 2 against the reference arrays'
  ``addressable_shards`` on device r: parameters and ``master`` at atol =
  rtol = 1e-5; the moments per leaf within ``1e-5 |ref| + 1e-6
  max|ref|`` (``test_torch_train.py``'s rule: sums in other orders);
- the shards of a leaf that two ranks both hold are equal bit for bit.

Also: the control (dp=2 x mp=2 with the gradient's sum over dp skipped
must fail the parameter comparison); ``ring_attention`` and
``ulysses_attention`` outputs and q / k / v gradients against the
reference's under ``jax.shard_map`` (atol = rtol = 1e-5); each collective
forward and backward against its numpy definition (exact but for sums,
1e-6); the specs (with and without ``pp``) against the reference's
table; a one-position mesh is the one-device step bit for bit; a world of
another size and the pipeline arguments on a mesh without ``pp`` raise;
a pp=2 x dp=2 mesh builds (``test_torch_pipeline.py`` runs the pipeline
axis).

The reference's ``param_specs`` lists ``lm_head`` for a tied tree too, so
its ``build_train_step`` refuses a tied tree on every mesh (the tree and
its shardings differ by that key); for the tied case the fixture drops
the key from the reference's specs.
"""

import dataclasses
import datetime
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from paddle_tpu_torch.distributed import mesh as dmesh
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils import convert
from torch_threads import one_torch_thread  # noqa: F401

WORLD, B, S, LR = 4, 4, 32, 3e-4
#: name -> (mesh axes, sep attention, tied embeddings, xent chunk)
MESHES = {
    "dp2_mp2": (dict(dp=2, mp=2), "ring", False, 0),
    "sharding2_mp2_chunked": (dict(sharding=2, mp=2), "ring", False, 8),
    "mp4_tied": (dict(mp=4), "ring", True, 0),
    "sep2_dp2_ring": (dict(dp=2, sep=2), "ring", False, 0),
    "sep2_mp2_ulysses": (dict(sep=2, mp=2), "ulysses", False, 0),
    "sep4_ring": (dict(sep=4), "ring", False, 0),
}
CONTROL = "dp2_mp2"
#: attention cases: (impl, sep ranks, causal, q heads, kv heads)
ATTN = {"ring4_causal_gqa": ("ring", 4, True, 4, 2),
        "ring2_full": ("ring", 2, False, 4, 4),
        "ulysses2_repeat": ("ulysses", 2, True, 4, 1),
        "ulysses4": ("ulysses", 4, True, 4, 4)}
ATTN_SHAPE = (2, 16, 8)                 # batch, global sequence, head_dim
#: the reference's plain references for its Pallas kernels on this path
PLAIN_PALLAS = "flash_attention,rms_norm"
RANKS_TIMEOUT_S = 300
#: the moments after the second step, per leaf, within ``1e-5 |ref| +
#: CHAINED_FLOOR * max|ref|``: the first AdamW update divides each
#: gradient element by its own root mean square, so where an element is
#: near 0 its rounding noise moves that parameter by up to lr, and the
#: second step's gradients by up to ~5e-6 of a leaf's max (measured on
#: the dp and sep meshes; the first step's gradients are held at 1e-6)
CHAINED_FLOOR = 1e-5


def _cfg(tied=False):
    return dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32,
                               tie_word_embeddings=tied)


def _tree(tied=False, seed=0):
    """Every leaf random (norms near 1, matrices at 0.05), numpy f32, in
    ``init_params``' shapes."""
    cfg = _cfg(tied)
    rs = np.random.RandomState(seed)
    L, h, i, V = (cfg.num_hidden_layers, cfg.hidden_size,
                  cfg.intermediate_size, cfg.vocab_size)
    q = cfg.num_attention_heads * cfg.head_dim
    kv = cfg.num_key_value_heads * cfg.head_dim

    def mat(*shape):
        return (0.05 * rs.standard_normal(shape)).astype(np.float32)

    def norm(*shape):
        return (1.0 + 0.1 * rs.standard_normal(shape)).astype(np.float32)

    tree = {"embed": mat(V, h), "final_norm": norm(h),
            "layers": {"input_norm": norm(L, h), "post_norm": norm(L, h),
                       "wq": mat(L, h, q), "wk": mat(L, h, kv),
                       "wv": mat(L, h, kv), "wo": mat(L, q, h),
                       "w_gate": mat(L, h, i), "w_up": mat(L, h, i),
                       "w_down": mat(L, i, h)}}
    if not tied:
        tree["lm_head"] = mat(h, V)
    return tree


def _batch():
    rs = np.random.RandomState(1)
    V = _cfg().vocab_size
    return (rs.randint(0, V, (B, S)).astype(np.int32),
            rs.randint(0, V, (B, S)).astype(np.int32))


def _attn_inputs(hq, hkv):
    b, s, d = ATTN_SHAPE
    rs = np.random.RandomState(hq * 10 + hkv)
    f = lambda h: (0.5 * rs.standard_normal((b, s, h, d))).astype(np.float32)
    return f(hq), f(hkv), f(hkv), f(hq)          # q, k, v, cotangent


def _coll_inputs():
    """Each rank's input and the cotangents of each collective's output."""
    rs = np.random.RandomState(7)
    x = rs.standard_normal((WORLD, 4, 8, 6)).astype(np.float32)
    cot = {"psum": (4, 8, 6), "copy_to": (4, 8, 6), "all_gather": (4, 32, 6),
           "reduce_scatter": (4, 2, 6), "ppermute": (4, 8, 6),
           "all_to_all": (16, 2, 6), "psum2": (4, 8, 6)}
    return x, {k: rs.standard_normal((WORLD,) + s).astype(np.float32)
               for k, s in cot.items()}


# ---------------- the ranks ----------------

def _numpy_state(params, opt):
    return {"params": convert.params_to_numpy(params),
            "opt": convert.opt_state_to_numpy(opt)}


def _train(name, mesh_kw, impl, tied, chunk, skip_dp_sum=False):
    cfg = _cfg(tied)
    mesh = tllama.make_mesh(**mesh_kw)
    step, opt_init, specs, dspec = tllama.build_train_step(
        cfg, mesh, lr=LR, sep_attn_impl=impl)
    full = convert.params_from_numpy(_tree(tied), device="cpu")
    params = convert.shard_params(cfg, full, specs, mesh)
    # a copy: on the CPU the arrays share the tensors' memory, which the
    # step updates in place
    first = convert.params_to_numpy(tllama._tree_map(torch.clone, params))
    whole = convert.gather_params(cfg, params, specs, mesh)
    opt = opt_init(params)
    cut = convert.shard_opt_state(cfg, tllama.adamw_init(full), specs, mesh)
    round_trip = {
        "params": all(torch.equal(a, b) for a, b in zip(
            tllama.tree_leaves(whole), tllama.tree_leaves(full))),
        "opt": all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
            tllama.tree_leaves(opt), tllama.tree_leaves(cut)))}
    ids, labels = (dmesh.shard_leaf(torch.from_numpy(t), dspec, mesh)
                   for t in _batch())
    sync = tllama._sync_axes
    if skip_dp_sum:
        tllama._sync_axes = lambda *a: tuple(x for x in sync(*a) if x != "dp")
    if chunk:
        os.environ["PADDLE_TPU_XENT_CHUNK"] = str(chunk)
    steps = []
    try:
        for _ in range(2):
            dmesh.reset_counters()
            loss, params, opt = step(params, opt, ids, labels)
            steps.append({"loss": loss.item(), "gnorm": opt["gnorm"].item(),
                          "collectives": dict(dmesh.COUNTERS),
                          "m": convert.params_to_numpy(
                              tllama._tree_map(torch.clone, opt["m"]))})
    finally:
        tllama._sync_axes = sync
        os.environ.pop("PADDLE_TPU_XENT_CHUNK", None)
    return {"first": first, "steps": steps, "coords": mesh.coords,
            "round_trip": round_trip, "final": _numpy_state(params, opt)}


def _attention(rank):
    from paddle_tpu_torch.ops import ring_attention as ra

    out = {}
    for name, (impl, n, causal, hq, hkv) in ATTN.items():
        mesh = tllama.make_mesh(sep=n, dp=WORLD // n)
        i, s_loc = mesh.axis_index("sep"), ATTN_SHAPE[1] // n
        q, k, v, cot = (torch.from_numpy(t[:, i * s_loc:(i + 1) * s_loc])
                        .clone() for t in _attn_inputs(hq, hkv))
        for t in (q, k, v):
            t.requires_grad_(True)
        fn = ra.ring_attention if impl == "ring" else ra.ulysses_attention
        o = fn(q, k, v, mesh, "sep", causal=causal)
        grads = torch.autograd.grad((o * cot).sum(), (q, k, v))
        out[name] = {"sep": i, "out": o.detach().numpy(),
                     "grads": [g.numpy() for g in grads]}
    return out


def _collectives(rank):
    x, cots = _coll_inputs()
    out = {}
    mesh = tllama.make_mesh(sep=WORLD)
    ops = {"psum": lambda t: dmesh.psum(t, mesh, "sep"),
           "copy_to": lambda t: dmesh.copy_to(t, mesh, "sep"),
           "all_gather": lambda t: dmesh.all_gather(t, mesh, "sep", 1),
           "reduce_scatter": lambda t: dmesh.reduce_scatter(t, mesh, "sep",
                                                            1),
           "ppermute": lambda t: dmesh.ppermute(t, mesh, "sep", 1),
           "all_to_all": lambda t: dmesh.all_to_all(t, mesh, "sep", 1, 0)}
    mesh2 = tllama.make_mesh(dp=2, mp=2)
    ops["psum2"] = lambda t: dmesh.psum(t, mesh2, ("dp", "mp"))
    for name, op in ops.items():
        t = torch.from_numpy(x[rank]).clone().requires_grad_(True)
        y = op(t)
        g, = torch.autograd.grad((y * torch.from_numpy(cots[name][rank]))
                                 .sum(), t)
        out[name] = (y.detach().numpy(), g.numpy())
    return out


def _errors():
    """A world of another size raises; a mesh with pp (now ported) builds:
    its coordinates and the step's specs, or the error either raised."""
    out = {}
    for name, fn in (
            ("world", lambda: tllama.make_mesh(dp=2)),
            ("pp_mesh", lambda: tllama.build_train_step(
                _cfg(), dmesh.Mesh(pp=2, dp=2))[2]),
            ("pp_make_mesh", lambda: tllama.make_mesh(pp=2, dp=2).coords)):
        try:
            out[name] = ("ok", fn())
        except Exception as e:
            out[name] = (type(e).__name__, str(e))
    return out


def _rank_cases(rank):
    out = {"rank": rank, "train": {}}
    t0 = time.perf_counter()
    for name, (kw, impl, tied, chunk) in MESHES.items():
        out["train"][name] = _train(name, kw, impl, tied, chunk)
    out["control"] = _train(CONTROL, *MESHES[CONTROL], skip_dp_sum=True)
    out["attention"] = _attention(rank)
    out["collectives"] = _collectives(rank)
    out["errors"] = _errors()
    out["seconds"] = time.perf_counter() - t0
    out["forbidden"] = sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib",
                                                     "paddle_tpu"))
    return out


def _rank_main(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(_rank_cases(rank), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------- the JAX references ----------------

def _jax_train(name):
    """The reference's two steps on ``name``'s mesh: its device shards of
    the parameters before, the loss and gnorm of each step, and each
    leaf's shard on each device after step 2."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.models import llama as jllama

    kw, impl, tied, chunk = MESHES[name]
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32,
                               tie_word_embeddings=tied)
    devices = jax.devices()[:WORLD]
    mesh = jllama.make_mesh(**kw, devices=devices)
    mpatch = pytest.MonkeyPatch()
    if tied:
        specs = jllama.param_specs
        mpatch.setattr(jllama, "param_specs", lambda *a, **k: {
            key: v for key, v in specs(*a, **k).items() if key != "lm_head"})
    if chunk:
        mpatch.setenv("PADDLE_TPU_XENT_CHUNK", str(chunk))
    try:
        step, opt_init, pshard, dshard = jllama.build_train_step(
            jcfg, mesh, lr=LR, sep_attn_impl=impl)
        p = jax.device_put(_tree(tied), pshard)
        first = _device_shards(p, devices)
        o = opt_init(p)
        ids, labels = (jax.device_put(t, dshard) for t in _batch())
        steps = []
        for _ in range(2):
            loss, p, o = step(p, o, ids, labels)
            steps.append({"loss": float(loss), "gnorm": float(o["gnorm"]),
                          "m": _device_shards(o["m"], devices)})
    finally:
        mpatch.undo()
    return {"first": first, "steps": steps,
            "final": {"params": _device_shards(p, devices),
                      "opt": {k: _device_shards(o[k], devices)
                              for k in ("m", "v", "master")}}}


def _device_shards(tree, devices):
    """Each leaf as {device index: its shard}, the tree's structure kept."""
    if isinstance(tree, dict):
        return {k: _device_shards(v, devices) for k, v in tree.items()}
    by_dev = {sh.device: np.asarray(sh.data) for sh in tree.addressable_shards}
    return {r: by_dev[d] for r, d in enumerate(devices)}


def _jax_attention():
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.ops import ring_attention as jra

    out = {}
    for name, (impl, n, causal, hq, hkv) in ATTN.items():
        mesh = Mesh(np.array(jax.devices()[:n]), ("sep",))
        spec = P(None, "sep")
        fn = jra.ring_attention if impl == "ring" else jra.ulysses_attention

        def run(q, k, v, fn=fn, causal=causal, mesh=mesh, spec=spec):
            return jax.shard_map(
                lambda a, b_, c: fn(a, b_, c, "sep", causal=causal),
                mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                check_vma=False)(q, k, v)

        q, k, v, cot = _attn_inputs(hq, hkv)
        o, vjp = jax.vjp(jax.jit(run), q, k, v)
        out[name] = (np.asarray(o), [np.asarray(g) for g in vjp(cot)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_train_ranks"))
    ctx = mp.spawn(_rank_main, args=(tmp,), nprocs=WORLD, join=False)
    mpatch = pytest.MonkeyPatch()
    mpatch.setenv("PADDLE_TPU_DISABLE_PALLAS", PLAIN_PALLAS)
    try:
        ref = {name: _jax_train(name) for name in MESHES}
        attn = _jax_attention()
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        mpatch.undo()
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "ref": ref, "attn": attn}


# ---------------- the mesh train step ----------------

def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested dict whose leaves are arrays or
    {rank: array} dicts."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and not all(isinstance(x, int) for x in v):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _moment_close(got, want, floor):
    return bool((np.abs(got - want)
                 <= 1e-5 * np.abs(want) + floor * np.abs(want).max()).all())


def _state_mismatches(rank_runs, ref):
    """The (rank, tree, leaf) whose shard misses the reference's after
    step 2, with the largest difference: parameters and ``master`` at atol
    = rtol = 1e-5, the moments within ``1e-5 |ref| + 1e-5 max|ref|`` (see
    :data:`CHAINED_FLOOR`)."""
    bad = []
    for r, run in enumerate(rank_runs):
        for tree in ("params", "m", "v", "master"):
            mine = (run["final"]["params"] if tree == "params"
                    else run["final"]["opt"][tree])
            theirs = (ref["final"]["params"] if tree == "params"
                      else ref["final"]["opt"][tree])
            for path, want in _leaves(theirs):
                got, want = _get(mine, path), want[r]
                assert got.shape == want.shape, (r, tree, path)
                if tree in ("m", "v"):
                    ok = _moment_close(got, want, CHAINED_FLOOR)
                else:
                    ok = np.allclose(got, want, atol=1e-5, rtol=1e-5)
                if not ok:
                    bad.append((r, tree, path,
                                float(np.abs(got - want).max())))
    return bad


@pytest.mark.parametrize("name", list(MESHES))
def test_first_shards_are_the_reference_device_shards(runs, name):
    """``shard_params`` gives each rank the reference's device shard bit
    for bit, ``gather_params`` puts the whole tree back, and
    ``shard_opt_state`` of the whole tree's AdamW state is ``opt_init``
    of the shards."""
    for r, rank in enumerate(runs["ranks"]):
        assert rank["train"][name]["round_trip"] == {"params": True,
                                                     "opt": True}
        mine = rank["train"][name]["first"]
        for path, want in _leaves(runs["ref"][name]["first"]):
            np.testing.assert_array_equal(_get(mine, path), want[r],
                                          err_msg=f"rank {r} {path}")


@pytest.mark.parametrize("name", list(MESHES))
def test_loss_and_gnorm_match_reference(runs, name):
    want = runs["ref"][name]["steps"]
    for rank in runs["ranks"]:
        for i, (got, ref) in enumerate(zip(rank["train"][name]["steps"],
                                           want)):
            for key in ("loss", "gnorm"):
                np.testing.assert_allclose(got[key], ref[key], atol=1e-5,
                                           rtol=1e-5,
                                           err_msg=f"step {i + 1} {key}")


@pytest.mark.parametrize("name", list(MESHES))
def test_state_shards_after_two_steps_match_reference(runs, name):
    bad = _state_mismatches([r["train"][name] for r in runs["ranks"]],
                            runs["ref"][name])
    assert not bad, bad


@pytest.mark.parametrize("name", list(MESHES))
def test_step1_gradient_shards_match_reference(runs, name):
    """The first moment after step 1 is ``(1 - beta1) * clip * g``: each
    rank's gradient shards, held per leaf within ``1e-5 |ref| + 1e-6
    max|ref|`` (``test_torch_train.py``'s rule)."""
    want = runs["ref"][name]["steps"][0]["m"]
    for r, rank in enumerate(runs["ranks"]):
        mine = rank["train"][name]["steps"][0]["m"]
        for path, w in _leaves(want):
            got = _get(mine, path)
            assert _moment_close(got, w[r], 1e-6), (
                r, path, float(np.abs(got - w[r]).max()),
                float(np.abs(w[r]).max()))


@pytest.mark.parametrize("name", list(MESHES))
def test_shared_shards_equal_across_ranks(runs, name):
    """Ranks at the same coordinates on every axis a leaf is split on hold
    the same shard, and it is bit for bit the same after two steps."""
    cfg = _cfg(MESHES[name][2])
    specs = tllama.param_specs(cfg, mp=MESHES[name][0].get("mp", 1))
    runs_ = [r["train"][name] for r in runs["ranks"]]
    checked = 0
    for tree in ("params", "m", "v", "master"):
        for path, spec in tllama.named_specs(cfg, specs):
            axes = dmesh.spec_axes(spec)
            held = {}
            for run in runs_:
                key = tuple(run["coords"][a] for a in axes)
                state = run["final"]
                t = _get(state["params"] if tree == "params"
                         else state["opt"][tree], path)
                if key in held:
                    np.testing.assert_array_equal(t, held[key],
                                                  err_msg=f"{tree} {path}")
                    checked += 1
                held[key] = t
    assert checked > 0


def test_control_without_dp_sum_fails_the_comparison(runs):
    """The same dp=2 x mp=2 run with the gradient's sum over dp skipped
    misses the reference: the comparison can fail."""
    ranks = [r["control"] for r in runs["ranks"]]
    assert _state_mismatches(ranks, runs["ref"][CONTROL])
    assert not _state_mismatches([r["train"][CONTROL] for r in runs["ranks"]],
                                 runs["ref"][CONTROL])


def test_collective_counts_per_step(runs):
    """The collectives a step ran on rank 0, as the design predicts them
    (full recompute, L layers).  dp=2 x mp=2: each layer's two ``psum``
    in the forward and its first again in the recompute (3L: the
    recompute stops at the last tensor the backward saved, the MLP's
    product before its ``psum``), the embedding's
    ``psum``, the vocab-parallel head's two sums (and one max), the two
    ``copy_to`` backward sums a layer (2L) and the head's, the loss's sum
    over dp, the gradient sync over dp (one a leaf, 12) and the norm's one
    sum over mp (the replicated leaves' squares need none)."""
    L = _cfg().num_hidden_layers
    c = runs["ranks"][0]["train"]["dp2_mp2"]["steps"][1]["collectives"]
    assert c["all_reduce_max"] == 1
    assert c["all_reduce"] == 3 * L + 1 + 2 + 2 * L + 1 + 1 + 12 + 1
    assert c["all_gather"] == c["reduce_scatter"] == c["ppermute"] == 0
    # ZeRO: every leaf split over sharding is gathered at each use (the
    # layers' 7 matrices twice, forward and recompute; embed and lm_head
    # once) and its gradient reduce-scattered once a use
    c = runs["ranks"][0]["train"]["sharding2_mp2_chunked"]["steps"][1][
        "collectives"]
    assert c["all_gather"] == 2 * 7 * L + 2
    assert c["reduce_scatter"] == 7 * L + 2
    # the ring: K/V rotate 3 times a layer over 4 ranks, forward and
    # recompute, and the cotangents rotate back 3 times
    c = runs["ranks"][0]["train"]["sep4_ring"]["steps"][1]["collectives"]
    assert c["ppermute"] == 3 * 3 * L
    c = runs["ranks"][0]["train"]["sep2_mp2_ulysses"]["steps"][1][
        "collectives"]
    # Ulysses: q, k, v and the output swap a layer, forward, recompute
    # and backward
    assert c["all_to_all"] == 4 * 3 * L


def test_ranks_import_no_jax(runs):
    for rank in runs["ranks"]:
        assert rank["forbidden"] == []


# ---------------- attention and collectives ----------------

@pytest.mark.parametrize("name", list(ATTN))
def test_sep_attention_matches_reference_under_shard_map(runs, name):
    impl, n, causal, hq, hkv = ATTN[name]
    want_o, want_g = runs["attn"][name]
    s_loc = ATTN_SHAPE[1] // n
    for rank in runs["ranks"]:
        got = rank["attention"][name]
        sl = slice(got["sep"] * s_loc, (got["sep"] + 1) * s_loc)
        np.testing.assert_allclose(got["out"], want_o[:, sl], atol=1e-5,
                                   rtol=1e-5)
        for which, g, w in zip("qkv", got["grads"], want_g):
            np.testing.assert_allclose(g, w[:, sl], atol=1e-5, rtol=1e-5,
                                       err_msg=f"d{which}")


def _collective_defs(x, c):
    """Each collective's forward and backward for every rank, in numpy."""
    n = WORLD
    X, C = list(x), {k: list(v) for k, v in c.items()}
    out = {
        "psum": ([sum(X)] * n, C["psum"]),
        "copy_to": (X, [sum(C["copy_to"])] * n),
        "all_gather": ([np.concatenate(X, 1)] * n,
                       [sum(C["all_gather"])[:, 8 * r:8 * r + 8]
                        for r in range(n)]),
        "reduce_scatter": ([sum(X)[:, 2 * r:2 * r + 2] for r in range(n)],
                           [np.concatenate(C["reduce_scatter"], 1)] * n),
        "ppermute": ([X[(r - 1) % n] for r in range(n)],
                     [C["ppermute"][(r + 1) % n] for r in range(n)]),
        "all_to_all": (
            [np.concatenate([X[j][:, 2 * r:2 * r + 2] for j in range(n)], 0)
             for r in range(n)],
            [np.concatenate([C["all_to_all"][j][4 * r:4 * r + 4]
                             for j in range(n)], 1) for r in range(n)]),
        "psum2": ([sum(X)] * n, C["psum2"]),
    }
    return out


def test_collectives_forward_and_backward_match_numpy(runs):
    x, cots = _coll_inputs()
    defs = _collective_defs(x, cots)
    for r, rank in enumerate(runs["ranks"]):
        for name, (fwd, bwd) in defs.items():
            y, g = rank["collectives"][name]
            np.testing.assert_allclose(y, fwd[r], atol=1e-6, rtol=1e-6,
                                       err_msg=f"{name} forward, rank {r}")
            np.testing.assert_allclose(g, bwd[r], atol=1e-6, rtol=1e-6,
                                       err_msg=f"{name} backward, rank {r}")


# ---------------- specs, the one-position mesh, errors ----------------

@pytest.mark.parametrize("mp_", [1, 2, 4])
def test_param_specs_match_reference(mp_):
    import jax.numpy as jnp

    from paddle_tpu.models import llama as jllama

    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    want = jllama.param_specs(jcfg, mp=mp_)
    got = tllama.param_specs(_cfg(), mp=mp_)
    for path, spec in _leaves(got):
        assert tuple(_get(want, path)) == spec, path
    assert set(got) == set(want) and set(got["layers"]) == set(
        want["layers"])
    assert tllama.DATA_SPEC == (("dp", "sharding"), "sep")
    want = jllama.param_specs(jcfg, pp=True, mp=mp_)
    got = tllama.param_specs(_cfg(), pp=True, mp=mp_)
    for path, spec in _leaves(got):
        assert tuple(_get(want, path)) == spec, path
    assert got["layers"]["wq"][0] == "pp"


def test_one_position_mesh_is_the_one_device_step():
    cfg = _cfg()
    ids, labels = (torch.from_numpy(t) for t in _batch())
    out = []
    for mesh in (None, tllama.make_mesh()):
        built = tllama.build_train_step(cfg, mesh, lr=LR)
        step, opt_init = built[:2]
        assert len(built) == (2 if mesh is None else 4)
        params = convert.params_from_numpy(_tree(), device="cpu")
        opt = opt_init(params)
        losses = [step(params, opt, ids, labels)[0] for _ in range(2)]
        out.append((losses, params, opt))
    (l0, p0, o0), (l1, p1, o1) = out
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for a, b in zip(tllama.tree_leaves({"p": p0, "o": o0}),
                    tllama.tree_leaves({"p": p1, "o": o1})):
        assert torch.equal(a, b)


def test_errors(runs):
    """A world of another size raises, in the ranks and without a process
    group; a pp=2 x dp=2 mesh lays the ranks out as the reference's
    ``devices.reshape(dp, pp, ...)`` and its train step's specs put the
    layers over pp (``tests/test_torch_pipeline.py`` runs it)."""
    for r, rank in enumerate(runs["ranks"]):
        errs = rank["errors"]
        assert errs["world"][0] == "ValueError" and "world of 4" in errs[
            "world"][1]
        kind, coords = errs["pp_make_mesh"]
        assert kind == "ok" and (coords["dp"], coords["pp"]) == divmod(r, 2)
        kind, specs = errs["pp_mesh"]
        assert kind == "ok" and specs == tllama.param_specs(_cfg(), pp=True)
    with pytest.raises(ValueError, match="process group"):
        tllama.make_mesh(dp=2)
    with pytest.raises(ValueError, match="process group"):
        tllama.make_mesh(pp=2)


@pytest.mark.parametrize("kw", [dict(pipeline_schedule="1f1b"),
                                dict(pipeline_schedule="gpipe"),
                                dict(pipeline_schedule="bogus"),
                                dict(num_chunks=2)])
def test_pipeline_arguments_raise_as_the_reference(kw):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.models import llama as jllama

    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    with pytest.raises(ValueError) as want:
        jllama.build_train_step(jcfg, jllama.make_mesh(
            devices=jax.devices()[:1]), **kw)
    with pytest.raises(ValueError) as got:
        tllama.build_train_step(_cfg(), tllama.make_mesh(), **kw)
    assert str(got.value) == str(want.value)
