"""The port stands alone: importing ``paddle_tpu_torch`` pulls in neither
``jax`` nor ``paddle_tpu``, no module of the package (nor ``chip_smoke.py``)
imports them, and entry points asked for a CUDA device with no card raise
instead of running on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.inference.serving,"
            " paddle_tpu_torch.utils.convert, paddle_tpu_torch.ops."
            "decode_attention, paddle_tpu_torch.models.llama, "
            "paddle_tpu_torch.ops.kernels.flash_attention, "
            "paddle_tpu_torch.utils.threefry\n"
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


def test_engine_rejects_params_on_another_device():
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, device="cpu")
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        ContinuousBatchingEngine(cfg, params, max_seq=64, block_size=16,
                                 device="cpu")


@pytest.mark.parametrize("module", ["paddle_tpu_torch.inference.prefix_cache",
                                    "paddle_tpu_torch.inference.faults",
                                    "paddle_tpu_torch.utils.envflags"])
def test_serving_helpers_import_alone(module):
    """The prefix cache, the fault plan and the switch parsers are the
    port's own copies: importing one pulls in neither JAX nor the JAX
    package (the reference's modules of the same names import no JAX
    either, and the port still does not reach for them)."""
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
