"""The port stands alone: importing ``paddle_tpu_torch`` pulls in neither
``jax`` nor ``paddle_tpu``, no module of the package (nor ``chip_smoke.py``)
imports them, and entry points asked for a CUDA device with no card raise
instead of running on the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.inference.serving,"
            " paddle_tpu_torch.utils.convert, paddle_tpu_torch.ops."
            "decode_attention, paddle_tpu_torch.models.llama, "
            "paddle_tpu_torch.ops.kernels.flash_attention, "
            "paddle_tpu_torch.utils.threefry, "
            "paddle_tpu_torch.inference.fleet, paddle_tpu_torch.analysis, "
            "paddle_tpu_torch.models.moe_llama, paddle_tpu_torch.models.dit, "
            "paddle_tpu_torch.inference\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_cuda_without_card_raises():
    import paddle_tpu_torch
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models import llama

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle_tpu_torch.default_device()
    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(cfg)                    # default device: the card
    params = llama.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(cfg, params, max_seq=64, block_size=16,
                                 device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(cfg, params, max_seq=64, block_size=16)
    from paddle_tpu_torch.inference import FleetRouter

    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetRouter(cfg, params, n_replicas=2, max_seq=64, block_size=16)


def test_engine_rejects_params_on_another_device():
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, device="cpu")
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        ContinuousBatchingEngine(cfg, params, max_seq=64, block_size=16,
                                 device="cpu")


#: the serving helpers that are the port's own copies of reference modules
#: which import no JAX themselves, then the model and the engine (their
#: reference counterparts import JAX), each imported after the ones before
ALONE = ["paddle_tpu_torch.inference.prefix_cache",
         "paddle_tpu_torch.inference.faults",
         "paddle_tpu_torch.utils.envflags",
         "paddle_tpu_torch.nn.quant",
         "paddle_tpu_torch.profiler",
         "paddle_tpu_torch.inference.observability",
         "paddle_tpu_torch.inference.kv_tier",
         "paddle_tpu_torch.analysis.engine_audit",
         "paddle_tpu_torch.inference.fleet",
         "paddle_tpu_torch.models.llama",
         "paddle_tpu_torch.inference.serving"]


@pytest.fixture(scope="module")
def alone_imports():
    """One fresh interpreter imports each of ``ALONE`` in turn and reports,
    for each, the forbidden modules that import brought in (none was
    loaded before it, or an earlier module's report names it): module ->
    list."""
    code = ("import importlib, json, sys\n"
            f"mods = {ALONE!r}\n"
            "out = {}\n"
            "def bad():\n"
            "    return {m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')}\n"
            "for m in mods:\n"
            "    before = bad()\n"
            "    importlib.import_module(m)\n"
            "    out[m] = sorted(bad() - before)\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", ALONE)
def test_serving_helpers_import_alone(module, alone_imports):
    """The prefix cache, the fault plan, the switch parsers, the
    weight-only quantization, the host trace buffer, the observability
    module, the host KV tier, the engine auditor and the fleet router are
    the port's own copies: importing one pulls in neither JAX nor the JAX
    package (the reference's modules of the same names that import no JAX
    are not reached for either); so are the model and the serving engine
    with their tensor-parallel parts (``shard_serving_params``,
    ``env_tp``)."""
    assert alone_imports[module] == [], alone_imports[module]


@pytest.mark.parametrize("family", ["moe_llama", "dit"])
def test_new_model_families_resolve_to_the_card(family):
    """``init_params`` of the MoE decoder and the DiT take the card unless
    the caller asks for the CPU."""
    import importlib

    mod = importlib.import_module(f"paddle_tpu_torch.models.{family}")
    cfg = (mod.MoEConfig if family == "moe_llama" else mod.DiTConfig).tiny()
    params = mod.init_params(cfg, device="cpu")
    assert all(t.device.type == "cpu"
               for t in mod.llama.tree_leaves(params))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.init_params(cfg, device="cuda")
