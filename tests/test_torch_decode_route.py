"""The decode kernels' route rule, without a card.

``decode_route`` picks the hand-written kernel the fused decode step over
fp pools (B7) and over int8 / int4 pools (B11), and the unfused sequential
walk (B5), launch, from (dtype, head_dim) alone: the tensor-core
``csrc/fused_decode_tc.cu`` / ``csrc/paged_decode_tc.cu`` for bf16/f16 q at
head_dim 64 or 128, the CUDA-core ``csrc/fused_decode.cu`` /
``csrc/fused_quant_decode.cu`` / ``csrc/paged_decode.cu`` for every other
shape.  The sequential walk's tensor-core launch splits over the KV axis
by its own rule of the table width (``seq_decode_splits``).  The split-K
walk (B6) takes the same tensor-core kernel (``ptt_flash_decode_tc``) over
the caller's shards where ``decode_route`` names it and the shards are at
most 64 (``flash_decode_route``), else the CUDA-core ``ptt_flash_decode``
and its combine launch.  The kernels themselves are checked on the card
(``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from torch_threads import one_torch_thread  # noqa: F401

ROUTES = ([((dt, d), "tc") for dt in (torch.bfloat16, torch.float16)
           for d in (64, 128)]
          + [((torch.float32, d), "cc") for d in (64, 128, 32, 256)]
          + [((torch.bfloat16, d), "cc") for d in (32, 96, 160, 256)])


@pytest.mark.parametrize("key,route", ROUTES,
                         ids=[f"{dt}-{d}".replace("torch.", "")
                              for (dt, d), _ in ROUTES])
def test_decode_route_rule(key, route):
    dtype, d = key
    assert pa.decode_route(dtype, d) == route
    # the wrappers' route: the rule by default; the CUDA-core kernels take
    # every shape; the tensor-core kernel only its own
    q = torch.empty(1, 2, d, dtype=dtype)

    def pick(name, r):
        return tk.pick_route(name, q, r, pa.decode_route(dtype, d))

    for name in ("fused_decode_step", "fused_quant_decode_step",
                 "paged_decode"):
        assert pick(name, None) == route
        assert pick(name, "cc") == "cc"
        if route == "tc":
            assert pick(name, "tc") == "tc"
        else:
            with pytest.raises(ValueError, match=f"{name}: route 'tc'"):
                pick(name, "tc")


def test_decode_tc_counters_sit_beside_the_totals():
    """Each fused decode step and both unfused walks have a tensor-core
    counter beside their total, and a reset zeroes both."""
    for name in ("fused_decode_step", "fused_quant_decode_step",
                 "paged_decode", "flash_decode"):
        assert name in tk.LAUNCHES and f"{name}_tc" in tk.LAUNCHES
        tk.LAUNCHES[f"{name}_tc"] += 1
    tk.reset_counters()
    assert not any(tk.LAUNCHES.values())


@pytest.mark.parametrize("max_blocks", [1, 2, 3, 4, 5, 7, 8, 9, 16, 31, 32,
                                        33, 64, 100])
def test_seq_decode_splits_cover_every_page_once(max_blocks, monkeypatch):
    """The sequential walk's tensor-core splits: S runs of P table pages
    (P = ceil(max_blocks / S)) cover the table, none of them past it, at
    most 16; for every live length each page lies in exactly one live
    split (the kernel's ``nlive = ceil(npages / P)``, split s walking pages
    [s P, min((s + 1) P, npages))).  The ``flash_decode`` switch, which
    turns the split-K route's fan-out to 1, leaves this rule alone."""
    S = pa.seq_decode_splits(max_blocks)
    P = -(-max_blocks // S)
    assert 1 <= S <= min(16, max_blocks)
    assert S * P >= max_blocks and (S - 1) * P < max_blocks
    runs = max(1, min(16, -(-max_blocks // 4)))      # about 4 pages a run
    assert P == -(-max_blocks // runs)
    for npages in range(max_blocks + 1):
        nlive = min(S, -(-npages // P))
        seen = [j for s in range(nlive)
                for j in range(s * P, min((s + 1) * P, npages))]
        assert seen == list(range(npages))
        assert all(s * P < npages for s in range(nlive))
    monkeypatch.setenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", "flash_decode")
    assert pa.decode_shards(max_blocks) == 1
    assert pa.seq_decode_splits(max_blocks) == S


def test_seq_decode_split_bound_matches_the_kernel():
    """The rule's most splits is the most the tensor-core launch takes
    (``csrc/paged_decode_tc.cu`` refuses more), and a table of any width
    stays within it."""
    src = (Path(tk.__file__).parent / "csrc" /
           "paged_decode_tc.cu").read_text()
    assert f"constexpr int kMaxSplits = {pa._SEQ_MAX_SPLITS};" in src
    assert max(pa.seq_decode_splits(n) for n in range(1, 4097)) == \
        pa._SEQ_MAX_SPLITS


SPLITK = ([((dt, d, S), "tc") for dt in (torch.bfloat16, torch.float16)
           for d in (64, 128) for S in (1, 2, 8, 32, 64)]
          + [((torch.bfloat16, d, S), "cc") for d in (64, 128)
             for S in (65, 128)]
          + [((torch.float32, d, S), "cc") for d in (64, 128) for S in (2, 8)]
          + [((torch.bfloat16, d, 8), "cc") for d in (32, 96, 256)])


@pytest.mark.parametrize("key,route", SPLITK,
                         ids=[f"{dt}-{d}-S{S}".replace("torch.", "")
                              for (dt, d, S), _ in SPLITK])
def test_flash_decode_route_rule(key, route):
    """The split-K walk's route: the tensor cores where ``decode_route``
    names them and the shards fit one launch's merge (at most 64), the
    CUDA-core walk and its combine launch for every other shape; an
    explicit ``"tc"`` the rule does not name raises, naming the shards."""
    dtype, d, S = key
    assert pa.flash_decode_route(dtype, d, S) == route
    assert route == "cc" or pa.decode_route(dtype, d) == "tc"
    q = torch.empty(1, 2, d, dtype=dtype)

    def pick(r):
        return tk.pick_route("flash_decode", q, r,
                             pa.flash_decode_route(dtype, d, S),
                             f", {S} shards")

    assert pick(None) == route
    assert pick("cc") == "cc"
    if route == "tc":
        assert pick("tc") == "tc"
    else:
        with pytest.raises(ValueError,
                           match=f"flash_decode: route 'tc' .* {S} shards"):
            pick("tc")


@pytest.mark.parametrize("max_blocks", [1, 4, 32, 64, 128])
def test_flash_decode_shard_rule_takes_the_tensor_cores(max_blocks,
                                                        monkeypatch):
    """The reference's shard rule (at most 8 shards) always takes the
    tensor cores at bf16, d 128, and so does every explicit count up to 64;
    only a larger explicit count takes the CUDA cores.  The
    ``flash_decode`` switch leaves one shard (the sequential walk, which
    ``paged_attention_decode`` then takes)."""
    for n in (None, *range(1, max_blocks + 1)):
        S = pa.flash_decode_shards(max_blocks, n)
        assert S <= max_blocks
        want = "tc" if S <= pa._SPLITK_MAX_SHARDS else "cc"
        assert pa.flash_decode_route(torch.bfloat16, 128, S) == want
        assert want == "tc" or (n is not None and n > 64)
    monkeypatch.setenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", "flash_decode")
    assert pa.decode_shards(max_blocks) == 1


def test_splitk_shard_bound_matches_the_kernel():
    """The rule's most shards is the most the split-K tensor-core entry
    takes (``csrc/paged_decode_tc.cu`` refuses more), and no more than the
    kernel template's merge holds (``csrc/paged_tc.cuh``)."""
    csrc = Path(tk.__file__).parent / "csrc"
    src = (csrc / "paged_decode_tc.cu").read_text()
    tmpl = (csrc / "paged_tc.cuh").read_text()
    assert (f"constexpr int kMaxSplitKShards = {pa._SPLITK_MAX_SHARDS};"
            in src)
    assert "kv_format, stream, kMaxSplitKShards);" in src
    held = int(re.search(r"constexpr int kMaxLaunchShards = (\d+);",
                         tmpl).group(1))
    assert pa._SPLITK_MAX_SHARDS <= held
