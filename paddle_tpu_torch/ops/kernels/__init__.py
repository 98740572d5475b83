"""Hand-written CUDA kernels for Hopper (counterpart of ``ops/pallas``).

Each kernel module here holds three things side by side:

- the plain PyTorch version of the function (the CPU path, and the
  version ``chip_smoke.py`` holds the kernel against on the card);
- a wrapper that checks device, dtype, shape and contiguity, allocates the
  outputs with ``torch.empty`` and launches the CUDA kernel on PyTorch's
  current stream through ``ctypes``;
- a dispatch that picks by the tensor's device: CPU tensors take the plain
  version, CUDA tensors launch the kernel or raise.  There is no ``try``
  that falls back; the only way off the kernel on the card is the explicit
  operator switch :func:`kernel_disabled`.

The CUDA sources live in ``csrc/``.  :func:`library` compiles them with
``nvcc`` for ``sm_90a`` into ONE shared library with a plain C interface
(one ``nvcc -c`` per source, all started together, then one link), under
``build/`` beside this file, at first use.  The library is rebuilt when the
hash of the sources or the flags changes, so a fresh checkout builds
everything on its first call.  Nothing is compiled or loaded at import.

Launch counts: :data:`LAUNCHES` counts, per kernel, the launches a wrapper
made (one per kernel launch, nowhere else); :data:`PLAIN_CALLS` counts the
dispatches that took the plain version.  Both are plain ints that
:func:`reset_counters` zeroes.
"""

from __future__ import annotations

import ctypes
import difflib
import hashlib
import os
import shutil
import subprocess
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

#: the full opt-out vocabulary of ``PADDLE_TPU_TORCH_DISABLE_KERNELS``: the
#: port's kernel dispatch sites plus 'all' (counterpart of
#: ``ops/pallas/__init__.py``'s KNOWN_KERNELS).  The decode tokens mean what
#: the reference's do: ``paged_attention`` sends decode attention to the
#: gather oracle; ``flash_decode`` turns the split-K walk into the
#: sequential one; ``fused_decode_step`` (both pool kinds) and
#: ``fused_quant_append`` (quantized pools) are read when the serving
#: engine is built and rebuild it on the unfused decode arm.
KNOWN_KERNELS = frozenset({"all", "flash_attention", "rms_norm",
                           "paged_attention", "flash_decode",
                           "fused_decode_step", "fused_layer_mlp",
                           "fused_quant_append", "gumbel_noise"})

#: kernel name -> launches made by its wrapper.  ``paged_decode`` is the
#: sequential walk; ``flash_decode``, ``fused_decode_step`` and
#: ``fused_quant_decode_step`` count a walk and its combine launch as one;
#: ``paged_prefill`` and ``paged_verify`` are the ragged multi-row walks of
#: the mixed and the speculative verify step.  ``flash_attention_fwd``,
#: ``flash_attention_dkv`` and ``flash_attention_dq`` count every launch of
#: either route; ``flash_attention_fwd_tc``, ``flash_attention_dkv_tc`` and
#: ``flash_attention_dq_tc`` count the launches that took the tensor-core
#: route (``flash_route``).  Likewise ``paged_prefill`` / ``paged_verify``
#: count both routes and ``paged_prefill_tc`` / ``paged_verify_tc`` the
#: tensor-core one (``paged_rows_route``; a walk and the combine of its
#: split lanes count as one launch), and ``fused_decode_step`` /
#: ``fused_quant_decode_step`` both routes, ``fused_decode_step_tc`` /
#: ``fused_quant_decode_step_tc`` the tensor-core one (``decode_route``),
#: ``paged_decode`` both routes of the sequential walk and
#: ``paged_decode_tc`` its tensor-core one (``decode_route``), and
#: ``flash_decode`` both routes of the split-K walk and ``flash_decode_tc``
#: its tensor-core one (``flash_decode_route``: one launch, the partials
#: merged in it).
LAUNCHES = {"rms_norm": 0, "fused_decode_step": 0, "fused_layer_mlp": 0,
            "flash_attention_fwd": 0, "flash_attention_dkv": 0,
            "flash_attention_dq": 0, "flash_attention_fwd_tc": 0,
            "flash_attention_dkv_tc": 0, "flash_attention_dq_tc": 0,
            "gumbel_noise": 0, "paged_decode": 0,
            "flash_decode": 0, "fused_quant_decode_step": 0,
            "paged_prefill": 0, "paged_verify": 0, "paged_prefill_tc": 0,
            "paged_verify_tc": 0, "fused_decode_step_tc": 0,
            "fused_quant_decode_step_tc": 0, "paged_decode_tc": 0,
            "flash_decode_tc": 0}
#: kernel name -> dispatches that took the plain PyTorch version
PLAIN_CALLS = {name: 0 for name in LAUNCHES}

_ENV = "PADDLE_TPU_TORCH_DISABLE_KERNELS"
_warned: set[str] = set()


def reset_counters() -> None:
    """Zero every launch and plain-call count."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def kernel_disabled(name: str) -> bool:
    """Operator switch: route the named kernels to their plain versions.

    ``PADDLE_TPU_TORCH_DISABLE_KERNELS="rms_norm,fused_layer_mlp"`` (or
    ``"all"``) is read at every dispatch.  Unknown tokens warn once with a
    did-you-mean and are still honored (counterpart of
    ``paddle_tpu.ops.pallas.kernel_disabled``).  Unset, a CUDA tensor
    launches its kernel or raises."""
    raw = os.environ.get(_ENV, "")
    if not raw:
        return False
    tokens = {t.strip() for t in raw.split(",") if t.strip()}
    unknown = tokens - KNOWN_KERNELS - {name}
    if unknown and raw not in _warned:
        _warned.add(raw)
        hints = [f"{t!r}" + (f" (did you mean {c[0]!r}?)" if c else "")
                 for t in sorted(unknown)
                 for c in [difflib.get_close_matches(t, KNOWN_KERNELS, 1,
                                                     0.5)]]
        warnings.warn(f"{_ENV}={raw!r} contains unrecognized value(s) "
                      f"{', '.join(hints)}; known: {sorted(KNOWN_KERNELS)}")
    return "all" in tokens or name in tokens


def use_kernel(name: str, *tensors: torch.Tensor,
               switch: str | tuple[str, ...] | None = None) -> bool:
    """The dispatch rule every kernel module shares: False (and one plain
    call counted under ``name``) for CPU tensors or an explicitly disabled
    kernel; True for CUDA tensors; raises for any other device or a
    CPU/CUDA mix.  ``switch`` is the :data:`KNOWN_KERNELS` token (or
    tokens, any of which) that turns the kernel off (default: ``name``)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        switches = (switch,) if isinstance(switch, str) else switch
        if any(kernel_disabled(s) for s in switches or (name,)):
            PLAIN_CALLS[name] += 1
            return False
        return True
    if kinds == {"cpu"}:
        PLAIN_CALLS[name] += 1
        return False
    raise ValueError(f"{name}: tensors on devices {sorted(kinds)}; expected "
                     f"all on the CPU or all on one CUDA device")


def pick_route(name: str, q: torch.Tensor, route: str | None,
               rule: str, extra: str = "") -> str:
    """A two-route kernel's route: ``rule`` (the module's plain route
    function of q's dtype and head_dim, and of ``extra``, the rest of the
    shape it reads, when there is one) when ``route`` is None; ``"cc"``
    (the CUDA-core kernel) takes every shape its wrapper takes, ``"tc"``
    (the tensor cores) only where the rule names it."""
    if route is None:
        return rule
    if route not in ("tc", "cc") or (route == "tc" and rule != "tc"):
        raise ValueError(f"{name}: route {route!r} does not take dtype "
                         f"{q.dtype}, head_dim {q.shape[-1]}{extra}")
    return route


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
SOURCES = ("rms_norm.cu", "fused_decode.cu", "fused_mlp.cu", "flash_fwd.cu",
           "flash_bwd.cu", "flash_fwd_tc.cu", "flash_bwd_tc.cu", "gumbel.cu",
           "paged_decode.cu", "fused_quant_decode.cu", "paged_prefill.cu",
           "paged_prefill_tc.cu", "fused_decode_tc.cu",
           "paged_decode_tc.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")
_LIB_NAME = "libpaddle_tpu_torch_kernels.so"

_lib = None
_lib_lock = threading.Lock()
#: how the library was obtained on first use: {"seconds", "cached", "path"}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + tuple(sorted(p.name for p in CSRC.glob("*.cuh"))):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the CUDA sources into the shared library if the current
    sources' hash has no build yet; returns the library's path.  One
    ``nvcc -c`` per source runs in parallel, then one link."""
    out_dir = BUILD_DIR / source_hash()
    lib_path = out_dir / _LIB_NAME
    t0 = time.perf_counter()
    if lib_path.exists():
        BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=True,
                          path=str(lib_path))
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []

    def compile_one(src: str) -> tuple[Path, str]:
        obj = out_dir / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / src), "-o",
               str(obj)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n"
                               f"{res.stderr}")
        return obj, res.stderr

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        results = list(pool.map(compile_one, SOURCES))
    log = "\n".join(err for _, err in results if err)
    tmp = out_dir / (_LIB_NAME + f".tmp{os.getpid()}")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *[str(o) for o, _ in results]],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib_path)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      path=str(lib_path), ptxas=log)
    return lib_path


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry points: name -> argtypes (every one returns cudaGetLastError())
_SIGNATURES = {
    # x, w, out, rows, h, eps, dtype, stream
    "ptt_rms_norm": [_VP, _VP, _VP, _I, _I, _F, _I, _VP],
    # q, k_new, v_new, cos, sin, key_pool, value_pool, tables, lens, wblk,
    # wable, m, l, acc, out, b, nh, nkv, hd, nbp, bs, max_blocks, S, P,
    # scale, dtype, stream
    "ptt_fused_decode": [_VP] * 15 + [_I] * 9 + [_F, _I, _VP],
    # x, attn_y, norm_w, w_gate, w_up, w_down, h1, y, partial, B, h, F,
    # nsplit, eps, dtype, stream
    "ptt_fused_mlp": [_VP] * 9 + [_I] * 4 + [_F, _I, _VP],
    # q, k, v, mask, q_seg, kv_seg, out, lse, b, sq, skv, hq, hkv, d, mb,
    # mh, mask_kind, causal, scale, dtype, stream
    "ptt_flash_fwd": [_VP] * 8 + [_I] * 10 + [_F, _I, _VP],
    "ptt_flash_fwd_tc": [_VP] * 8 + [_I] * 10 + [_F, _I, _VP],
    # q, k, v, do, lse, delta, mask, q_seg, kv_seg, dk, dv, then as above
    "ptt_flash_dkv": [_VP] * 11 + [_I] * 10 + [_F, _I, _VP],
    "ptt_flash_dkv_tc": [_VP] * 11 + [_I] * 10 + [_F, _I, _VP],
    # q, k, v, do, lse, delta, mask, q_seg, kv_seg, dq, then as above
    "ptt_flash_dq": [_VP] * 10 + [_I] * 10 + [_F, _I, _VP],
    "ptt_flash_dq_tc": [_VP] * 10 + [_I] * 10 + [_F, _I, _VP],
    # seeds, pos, out, rows, n, stream
    "ptt_gumbel_noise": [_VP, _VP, _VP, _I, _I, _VP],
    # q, key_pool, value_pool, k_scale, v_scale, tables, lens, out, b, nh,
    # nkv, hd, nbp, bs, max_blocks, scale, dtype, kv_format, stream
    "ptt_paged_decode": [_VP] * 8 + [_I] * 7 + [_F, _I, _I, _VP],
    # q, key_pool, value_pool, k_scale, v_scale, tables, lens, m, l, acc,
    # out, b, nh, nkv, hd, nbp, bs, max_blocks, S, P, scale, dtype,
    # kv_format, stream
    "ptt_flash_decode": [_VP] * 11 + [_I] * 9 + [_F, _I, _I, _VP],
    # the sequential and the split-K walk's tensor-core routes: as
    # ptt_flash_decode with the tickets after acc
    "ptt_paged_decode_tc": [_VP] * 12 + [_I] * 9 + [_F, _I, _I, _VP],
    "ptt_flash_decode_tc": [_VP] * 12 + [_I] * 9 + [_F, _I, _I, _VP],
    # q, k_new, v_new, cos, sin, key_codes, value_codes, k_scale, v_scale,
    # tables, lens, wblk, wable, m, l, acc, out, b, nh, nkv, hd, nbp, bs,
    # max_blocks, S, P, scale, dtype, kv_format, stream
    "ptt_fused_quant_decode": [_VP] * 17 + [_I] * 9 + [_F, _I, _I, _VP],
    # the tensor-core routes: as ptt_fused_decode / ptt_fused_quant_decode
    # with the tickets after acc
    "ptt_fused_decode_tc": [_VP] * 16 + [_I] * 9 + [_F, _I, _VP],
    "ptt_fused_quant_decode_tc": [_VP] * 18 + [_I] * 9 + [_F, _I, _I, _VP],
    # q, key_pool, value_pool, k_scale, v_scale, tables, lens, q_lens, out,
    # b, T, nh, nkv, hd, nbp, bs, max_blocks, scale, dtype, kv_format,
    # stream
    "ptt_paged_prefill": [_VP] * 9 + [_I] * 8 + [_F, _I, _I, _VP],
    # as ptt_paged_prefill with the split partials m, l, acc after out, and
    # max_splits after max_blocks
    "ptt_paged_prefill_tc": [_VP] * 12 + [_I] * 9 + [_F, _I, _I, _VP],
}


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


#: dtype codes the C entry points take
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: KV pool storage codes the paged-attention entry points take (csrc/
#: paged.cuh KVFormat): the q dtype, int8 codes, packed int4 codes
KV_FORMAT_CODE = {None: 0, "int8": 1, "int4": 2}


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(name: str, err: int) -> None:
    """Raise if the C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")


def check_cuda_tensor(name: str, t: torch.Tensor, shape: tuple,
                      dtype: torch.dtype | tuple, device: torch.device):
    """Wrapper-side validation before a pointer goes to C."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
