"""The port's pipeline axis against the reference's on the CPU:
``build_train_step(cfg, make_mesh(..., pp=P), num_microbatches=4,
pipeline_schedule=...)`` under GPipe, 1F1B, VPP and ZB-H1, composed with
dp, sharding, mp and sep.

A tiny f32 Llama (``LlamaConfig.tiny`` with 4 layers: vocabulary 256,
hidden 64, 4 heads over 2 kv heads, ffn 128), every leaf drawn with numpy
from a seed, one batch of 8 x 32 tokens in 4 microbatches.  The port runs
as four gloo ranks, one ``torch.multiprocessing.spawn`` for the module (a
file store under the module's tmp dir), started before the parent runs
the JAX references on the conftest's host devices (``devices()[:4]``, so
rank r is device r; the references compile in :data:`JAX_THREADS`
threads); the ranks import this module, so it imports JAX only
inside the functions the parent runs.  Each rank runs every case and
writes what it saw with ``torch.save``.  The reference runs its flash
attention and RMSNorm through their plain references
(``PADDLE_TPU_DISABLE_PALLAS``), the port its plain versions.

The meshes (:data:`MESHES`): pp=4 1f1b; pp=2 x dp=2 under gpipe and
1f1b; pp=2 x sharding=2 vpp (2 chunks, ZeRO gathers inside the stage);
pp=2 x mp=2 zb; pp=2 x sep=2 ring 1f1b, Ulysses 1f1b and ring gpipe (the
reference's regression case for a ring inside a pipeline region).  The
gpipe pp=2 x dp=2 and the vpp mesh run the chunked loss
(``PADDLE_TPU_XENT_CHUNK``, :data:`CHUNKED`).  Held to the reference, two
steps from the same weights:

- each rank's first shards equal the reference's device shards of
  ``device_put(params, param_shardings)`` bit for bit;
- loss and gnorm after each step (atol = rtol = 1e-5);
- every rank's shard of every parameter and ``master`` leaf after step 2
  (atol = rtol = 1e-5), the moments per leaf within ``1e-5 |ref| + 1e-5
  max|ref|`` after step 2 (``test_torch_dist_train.py``'s chained rule)
  and the step-1 gradients within ``1e-5 |ref| + 2e-6 max|ref|``
  (:data:`MICRO_FLOOR`: sums of microbatches in other orders);
- the shards of a leaf two ranks hold are equal bit for bit;
- each rank's executed sub-ticks against the oracles
  (``distributed/fleet/pipeline.py`` says how each clock reads).

Also: ``loss_and_grads_1f1b`` with a tied head (pp=4) against the
reference's, loss and every gradient leaf; the oracles against the
reference's ``format_schedule`` strings over a grid of (P, M, C), and
the executed clock's order against them; every refusal the reference
makes raised with its type and message; a step's collectives as the
design predicts them; the control (pp=2 x dp=2 with the ``pp`` sum of
the embedding's gradient skipped must fail the parameter comparison).
"""

import dataclasses
import datetime
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from paddle_tpu_torch.distributed import mesh as dmesh
from paddle_tpu_torch.distributed.fleet import pipeline as tpl
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils import convert
from torch_threads import one_torch_thread  # noqa: F401

WORLD, B, S, M, LR = 4, 8, 32, 4, 3e-4
#: name -> (mesh axes, pipeline_schedule, num_chunks, sep attention)
MESHES = {
    "pp4_1f1b": (dict(pp=4), "1f1b", None, "ring"),
    "pp2_dp2_gpipe": (dict(pp=2, dp=2), "gpipe", None, "ring"),
    "pp2_dp2_1f1b": (dict(pp=2, dp=2), "1f1b", None, "ring"),
    "pp2_sharding2_vpp": (dict(pp=2, sharding=2), "vpp", 2, "ring"),
    "pp2_mp2_zb": (dict(pp=2, mp=2), "zb", None, "ring"),
    "pp2_sep2_ring_1f1b": (dict(pp=2, sep=2), "1f1b", None, "ring"),
    "pp2_sep2_ulysses_1f1b": (dict(pp=2, sep=2), "1f1b", None, "ulysses"),
    "pp2_sep2_ring_gpipe": (dict(pp=2, sep=2), "gpipe", None, "ring"),
}
CONTROL = "pp2_dp2_1f1b"
#: the meshes that run the sequence-chunked loss (``PADDLE_TPU_XENT_CHUNK``
#: positions, port and reference alike): GPipe's head on the whole batch,
#: 1F1B's head a microbatch at a time
XENT_CHUNK, CHUNKED = 8, ("pp2_dp2_gpipe", "pp2_sharding2_vpp")
#: name -> (mesh axes, build_train_step arguments, num_microbatches): one
#: case a refusal of the reference's
REFUSALS = {
    "zb_under_sep": (dict(pp=2, sep=2), dict(pipeline_schedule="zb"), 4),
    "zb_too_few_microbatches": (dict(pp=4), dict(pipeline_schedule="zb"), 4),
    "vpp_microbatches_not_a_multiple_of_pp": (
        dict(pp=2, dp=2), dict(pipeline_schedule="vpp"), 1),
    "vpp_layers_not_a_multiple_of_pp_chunks": (
        dict(pp=2, dp=2), dict(pipeline_schedule="vpp", num_chunks=4), 4),
    "num_chunks_without_vpp": (
        dict(pp=2, dp=2), dict(pipeline_schedule="1f1b", num_chunks=2), 4),
    "unknown_schedule": (dict(pp=2, dp=2),
                         dict(pipeline_schedule="pipedream"), 4),
}
#: (P, M, C) for the oracle grid
GRID = [(2, 4, 1), (2, 4, 2), (2, 6, 3), (3, 6, 1), (3, 6, 2), (4, 4, 1),
        (4, 8, 1), (4, 8, 2)]
#: the reference's plain references for its Pallas kernels on this path
PLAIN_PALLAS = "flash_attention,rms_norm"
RANKS_TIMEOUT_S = 300
#: threads compiling the JAX references (the four ranks run beside them)
JAX_THREADS = 4
#: the moments after step 2 (see ``test_torch_dist_train.py``)
CHAINED_FLOOR = 1e-5
#: the step-1 gradients, per leaf within ``1e-5 |ref| + MICRO_FLOOR *
#: max|ref|``: a pipeline's gradient is the sum of M microbatch
#: gradients, each rounded at its own size, which can exceed the sum's
#: where the microbatches cancel (measured: up to 1.2e-6 of the leaf's
#: max, on pp=4's last-stage ``wk``; one unsplit batch holds 1e-6)
MICRO_FLOOR = 2e-6


def _cfg(tied=False):
    return dataclasses.replace(tllama.LlamaConfig.tiny(layers=4),
                               dtype=torch.float32, tie_word_embeddings=tied)


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


def _chunks(schedule, num_chunks):
    return (num_chunks or 2) if schedule in ("vpp", "interleave") else 1


# ---------------- the ranks ----------------

def _train(mesh_kw, schedule, num_chunks, impl, skip_pp_sum=False,
           chunk=None):
    cfg = _cfg()
    mesh = tllama.make_mesh(**mesh_kw)
    step, opt_init, specs, dspec = tllama.build_train_step(
        cfg, mesh, lr=LR, num_microbatches=M, pipeline_schedule=schedule,
        num_chunks=num_chunks, sep_attn_impl=impl)
    full = convert.params_from_numpy(_tree(), device="cpu")
    params = convert.shard_params(cfg, full, specs, mesh)
    first = convert.params_to_numpy(tllama._tree_map(torch.clone, params))
    whole = convert.gather_params(cfg, params, specs, mesh)
    round_trip = all(torch.equal(a, b) for a, b in zip(
        tllama.tree_leaves(whole), tllama.tree_leaves(full)))
    opt = opt_init(params)
    ids, labels = (dmesh.shard_leaf(torch.from_numpy(t), dspec, mesh)
                   for t in _batch())
    sync = tllama._sync_axes
    if skip_pp_sum:
        tllama._sync_axes = lambda plan, name, spec: tuple(
            a for a in sync(plan, name, spec)
            if not (name == "embed" and a == "pp"))
    if chunk:
        os.environ["PADDLE_TPU_XENT_CHUNK"] = str(chunk)
    steps = []
    try:
        for _ in range(2):
            dmesh.reset_counters()
            loss, params, opt = step(params, opt, ids, labels)
            steps.append({"loss": loss.item(), "gnorm": opt["gnorm"].item(),
                          "collectives": dict(dmesh.COUNTERS),
                          "trace": list(tpl.TRACE),
                          "m": convert.params_to_numpy(
                              tllama._tree_map(torch.clone, opt["m"]))})
    finally:
        tllama._sync_axes = sync
        os.environ.pop("PADDLE_TPU_XENT_CHUNK", None)
    return {"first": first, "steps": steps, "coords": mesh.coords,
            "round_trip": round_trip,
            "final": {"params": convert.params_to_numpy(params),
                      "opt": convert.opt_state_to_numpy(opt)}}


def _tied_1f1b():
    """``loss_and_grads_1f1b`` on a tied tree at pp=4: the loss and the
    whole gradients (gathered over the mesh)."""
    cfg = _cfg(tied=True)
    mesh = tllama.make_mesh(pp=4)
    specs = tllama.param_specs(cfg, pp=True)
    params = convert.shard_params(
        cfg, convert.params_from_numpy(_tree(tied=True), device="cpu"),
        specs, mesh)
    ids, labels = (torch.from_numpy(t) for t in _batch())
    loss, grads = tllama.loss_and_grads_1f1b(cfg, params, ids, labels, mesh,
                                             M)
    named = tllama.named_specs(cfg, specs)
    return {"loss": loss.item(),
            "grads": {n: dmesh.unshard_leaf(g, spec, mesh).numpy()
                      for (n, spec), g in zip(named, grads)}}


def _refusal(mesh_kw, kw, n_micro):
    """The exception building the step and running it raises, as (type
    name, message), or None."""
    cfg = _cfg()
    try:
        mesh = tllama.make_mesh(**mesh_kw)
        step, opt_init, specs, dspec = tllama.build_train_step(
            cfg, mesh, lr=LR, num_microbatches=n_micro, **kw)
        params = convert.shard_params(
            cfg, convert.params_from_numpy(_tree(), device="cpu"), specs,
            mesh)
        ids, labels = (dmesh.shard_leaf(torch.from_numpy(t), dspec, mesh)
                       for t in _batch())
        step(params, opt_init(params), ids, labels)
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def _rank_cases(rank):
    out = {"rank": rank, "train": {}}
    t0 = time.perf_counter()
    for name, (kw, schedule, chunks, impl) in MESHES.items():
        out["train"][name] = _train(kw, schedule, chunks, impl,
                                    chunk=XENT_CHUNK if name in CHUNKED
                                    else None)
    kw, schedule, chunks, impl = MESHES[CONTROL]
    out["control"] = _train(kw, schedule, chunks, impl, skip_pp_sum=True)
    out["tied"] = _tied_1f1b()
    out["refusals"] = {name: _refusal(*case)
                       for name, case in REFUSALS.items()}
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

def _jcfg(tied=False):
    import jax.numpy as jnp

    from paddle_tpu.models import llama as jllama

    return dataclasses.replace(jllama.LlamaConfig.tiny(layers=4),
                               dtype=jnp.float32, tie_word_embeddings=tied)


def _jax_train(name):
    """The reference's two steps on ``name``'s mesh: its device shards of
    the parameters before, the loss, gnorm and first moment of each step,
    and each leaf's shard on each device after step 2."""
    import jax

    from paddle_tpu.models import llama as jllama

    kw, schedule, chunks, impl = MESHES[name]
    devices = jax.devices()[:WORLD]
    mesh = jllama.make_mesh(**kw, devices=devices)
    step, opt_init, pshard, dshard = jllama.build_train_step(
        _jcfg(), mesh, lr=LR, num_microbatches=M, pipeline_schedule=schedule,
        num_chunks=chunks, sep_attn_impl=impl)
    p = jax.device_put(_tree(), pshard)
    first = _device_shards(p, devices)
    o = opt_init(p)
    ids, labels = (jax.device_put(t, dshard) for t in _batch())
    steps = []
    for _ in range(2):
        loss, p, o = step(p, o, ids, labels)
        steps.append({"loss": float(loss), "gnorm": float(o["gnorm"]),
                      "m": _device_shards(o["m"], devices)})
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


def _jax_tied():
    import jax

    from paddle_tpu.models import llama as jllama

    mesh = jllama.make_mesh(pp=4, devices=jax.devices()[:WORLD])
    ids, labels = _batch()
    loss, grads = jax.jit(lambda p: jllama.loss_and_grads_1f1b(
        _jcfg(tied=True), p, ids, labels, mesh, M))(_tree(tied=True))
    return {"loss": float(loss),
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


def _jax_refusal(mesh_kw, kw, n_micro):
    import jax

    from paddle_tpu.models import llama as jllama

    try:
        mesh = jllama.make_mesh(**mesh_kw, devices=jax.devices()[:WORLD])
        step, opt_init, pshard, dshard = jllama.build_train_step(
            _jcfg(), mesh, lr=LR, num_microbatches=n_micro, **kw)
        p = jax.device_put(_tree(), pshard)
        ids, labels = (jax.device_put(t, dshard) for t in _batch())
        step(p, opt_init(p), ids, labels)
    except Exception as e:
        return type(e).__name__, str(e)
    return None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pipeline_ranks"))
    ctx = mp.spawn(_rank_main, args=(tmp,), nprocs=WORLD, join=False)
    mpatch = pytest.MonkeyPatch()
    mpatch.setenv("PADDLE_TPU_DISABLE_PALLAS", PLAIN_PALLAS)
    try:
        # XLA compiles outside the GIL: the references compile side by
        # side, the chunked ones after the others (the reference reads
        # PADDLE_TPU_XENT_CHUNK when it traces, from the process's env)
        with ThreadPoolExecutor(JAX_THREADS) as pool:
            ref = {name: pool.submit(_jax_train, name) for name in MESHES
                   if name not in CHUNKED}
            tied = pool.submit(_jax_tied)
            ref = {name: f.result() for name, f in ref.items()}
            tied = tied.result()
            mpatch.setenv("PADDLE_TPU_XENT_CHUNK", str(XENT_CHUNK))
            chunked = {name: pool.submit(_jax_train, name)
                       for name in CHUNKED}
            ref.update({name: f.result() for name, f in chunked.items()})
            mpatch.delenv("PADDLE_TPU_XENT_CHUNK")
        refusals = {name: _jax_refusal(*case)
                    for name, case in REFUSALS.items()}
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
    return {"ranks": ranks, "ref": ref, "tied": tied, "refusals": refusals}


# ---------------- the pipeline train step ----------------

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
    = rtol = 1e-5, the moments within ``1e-5 |ref| + 1e-5 max|ref|``."""
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
    """``shard_params`` of ``param_specs(pp=True)`` gives each rank the
    reference's device shard (its stage's L / P layers) bit for bit, and
    ``gather_params`` puts the whole tree back."""
    for r, rank in enumerate(runs["ranks"]):
        assert rank["train"][name]["round_trip"]
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
    rank's gradient shards within ``1e-5 |ref| + MICRO_FLOOR max|ref|``."""
    want = runs["ref"][name]["steps"][0]["m"]
    for r, rank in enumerate(runs["ranks"]):
        mine = rank["train"][name]["steps"][0]["m"]
        for path, w in _leaves(want):
            got = _get(mine, path)
            assert _moment_close(got, w[r], MICRO_FLOOR), (
                r, path, float(np.abs(got - w[r]).max()),
                float(np.abs(w[r]).max()))


@pytest.mark.parametrize("name", list(MESHES))
def test_shared_shards_equal_across_ranks(runs, name):
    """Ranks at the same coordinates on every axis a leaf is split on hold
    the same shard, bit for bit, after two steps (the stage-owned leaves
    across the pp stages included)."""
    kw = MESHES[name][0]
    cfg = _cfg()
    specs = tllama.param_specs(cfg, pp=True, mp=kw.get("mp", 1))
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


def _line(ticks):
    return tpl.format_schedule([ticks]).split(": ", 1)[1]


def _expected_order(schedule, P, C, s):
    """The oracle's order for stage ``s`` as the executed clock reads it
    (the pipeline module's docstring): 1F1B / VPP ``schedule_interleave``
    at their chunk count; ZB its C = 1 order with a W after the B of each
    of the first Z(s) microbatches, at its clock tick; GPipe FThenB's
    forwards, then its backwards reversed."""
    if schedule == "gpipe":
        ref = tpl.schedule_fthenb(P, M)[s]
        return ([t for t in ref if t.phase == "F"]
                + [t for t in reversed(ref) if t.phase == "B"])
    order = tpl.schedule_interleave(P, M, C)[s]
    if schedule != "zb":
        return order
    # W of microbatch w runs at tick s + M + w, after that tick's B (of
    # microbatch w + shift), or alone after the last B
    z, shift = min(M, 2 * (P - 1) - s), M + 2 * s - 2 * (P - 1)
    out = []
    for t in order:
        out.append(t)
        if t.phase == "B" and 0 <= t.mb - shift < z:
            out.append(tpl.Tick(s, t.mb - shift, "W"))
    return out + [tpl.Tick(s, w, "W") for w in range(z) if w + shift >= M]


@pytest.mark.parametrize("name", list(MESHES))
def test_executed_order_matches_the_oracle(runs, name):
    kw, schedule, chunks, _ = MESHES[name]
    P, C = kw["pp"], _chunks(schedule, chunks)
    for rank in runs["ranks"]:
        run = rank["train"][name]
        s = run["coords"]["pp"]
        for st in run["steps"]:
            assert _line(st["trace"]) == _line(
                _expected_order(schedule, P, C, s)), (name, s)


def test_control_without_pp_sum_fails_the_comparison(runs):
    """The pp=2 x dp=2 1F1B run with the ``pp`` sum of ``embed``'s
    gradient skipped misses the reference: the comparison can fail."""
    ranks = [r["control"] for r in runs["ranks"]]
    assert _state_mismatches(ranks, runs["ref"][CONTROL])
    assert not _state_mismatches([r["train"][CONTROL] for r in runs["ranks"]],
                                 runs["ref"][CONTROL])


def test_tied_1f1b_loss_and_grads_match_reference(runs):
    """pp=4 on a tied tree: ``embed``'s gradient is stage 0's embedding
    part plus stage 3's head part, summed over pp."""
    want = runs["tied"]
    for rank in runs["ranks"]:
        got = rank["tied"]
        np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5,
                                   rtol=1e-5)
        assert set(got["grads"]) == {p for p, _ in _leaves(want["grads"])}
        for path, w in _leaves(want["grads"]):
            assert _moment_close(got["grads"][path], w, MICRO_FLOOR), path


def test_collective_counts_per_step(runs):
    """The collectives of step 2 on rank 0 (stage 0) as the design
    predicts them.  pp=2 x dp=2 1F1B: the loss summed over pp, the
    stage-owned ``embed`` / ``final_norm`` / ``lm_head`` gradients over
    pp and dp, the 9 layer leaves over dp, the norm's one sum over pp;
    4 activations sent and 4 cotangents received.  GPipe on the same
    mesh: the outputs' and the embedding cotangent's sums over pp, the
    loss's over dp, all 12 gradients over dp and the norm's: M + P - 2 = 4
    shifts and as many transposes.  pp=2 x sharding=2 VPP: each F (8) and
    each B (8, forward and recompute) of a one-layer chunk gathers its 7
    matrices, stage 0 gathers the table at each of its 4 embeddings;
    each B reduce-scatters 7 and each embedding's backward one; 24 pipeline
    tensors, and the reorder's 9 leaves out and back (36)."""
    c = runs["ranks"][0]["train"]["pp2_dp2_1f1b"]["steps"][1]["collectives"]
    assert (c["all_reduce"], c["send_recv"], c["ppermute"]) == (
        1 + 3 + 9 + 1, 2 * M, 0)
    c = runs["ranks"][0]["train"]["pp2_dp2_gpipe"]["steps"][1]["collectives"]
    assert (c["all_reduce"], c["ppermute"], c["send_recv"]) == (
        2 + 1 + 12 + 1, 2 * (M + 2 - 2), 0)
    c = runs["ranks"][0]["train"]["pp2_sharding2_vpp"]["steps"][1][
        "collectives"]
    assert (c["all_gather"], c["reduce_scatter"]) == (
        7 * 8 + 2 * 7 * 8 + 4, 7 * 8 + 4)
    assert c["send_recv"] == 24 + 4 * 9
    for rank in runs["ranks"]:
        for name in MESHES:
            assert rank["train"][name]["steps"][1]["collectives"][
                "host_staged"] == 0          # CPU tensors need no staging


def test_ranks_import_no_jax(runs):
    for rank in runs["ranks"]:
        assert rank["forbidden"] == []


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_raise_as_the_reference(runs, name):
    want = runs["refusals"][name]
    assert want is not None
    for rank in runs["ranks"]:
        assert rank["refusals"][name] == want


# ---------------- the schedule oracles ----------------

@pytest.mark.parametrize("P,M_,C", GRID)
def test_oracles_match_the_reference_strings(P, M_, C):
    """The port's copies of the oracles print the reference's
    ``format_schedule`` strings (or raise its errors), and the executed
    clock's order (``Clock.schedule``) is ``schedule_interleave``'s at its
    chunk count, ZB's with W ticks added after their B."""
    from paddle_tpu.distributed.fleet import pipeline as jpl

    def both(name, *args):
        out = []
        for mod in (tpl, jpl):
            try:
                out.append(mod.format_schedule(getattr(mod, name)(*args)))
            except AssertionError as e:
                out.append(("AssertionError", str(e)))
        return out

    for name, args in (("schedule_fthenb", (P, M_)),
                       ("schedule_1f1b", (P, M_)),
                       ("schedule_eager_1f1b", (P, M_)),
                       ("schedule_zero_bubble", (P, M_)),
                       ("schedule_interleave", (P, M_, C))):
        got, want = both(name, *args)
        assert got == want, name
    assert set(tpl.SCHEDULES) == set(jpl.SCHEDULES)
    if M_ % P == 0:
        clock = tpl.Clock(P, M_, C).schedule()
        assert tpl.format_schedule(clock) == tpl.format_schedule(
            tpl.schedule_interleave(P, M_, C))
    if C == 1 and M_ >= 2 * P - 1:
        assert tpl.format_schedule(tpl.Clock(P, M_).schedule()) == \
            tpl.format_schedule(tpl.schedule_eager_1f1b(P, M_))
        zb = tpl.Clock(P, M_, 1, zero_bubble=True).schedule()
        for s, ticks in enumerate(zb):
            w = [t.mb for t in ticks if t.phase == "W"]
            assert w == list(range(min(M_, 2 * (P - 1) - s)))
            assert all(ticks.index(tpl.Tick(s, m, "W"))
                       > ticks.index(tpl.Tick(s, m, "B")) for m in w)
