"""The multi-row paged walk's route rule and its split over the KV axis,
without a card.

``paged_rows_route`` picks the hand-written walk the prefill and verify
wrappers launch from (dtype, head_dim) alone: the wgmma tensor-core walk
(``csrc/paged_prefill_tc.cu``) for bf16/f16 q at head_dim 64 or 128, the
f32 CUDA-core walk (``csrc/paged_prefill.cu``) for every other shape.  The
tensor-core walk splits the KV tiles of a lane whose live rows fit one row
tile over up to ``rows_max_splits`` blocks, by ``rows_split``: plain
functions, so they are checked here; the kernels themselves are checked
on the card (``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.ops.kernels import paged_attention as pa

ROUTES = ([((dt, d), "tc") for dt in (torch.bfloat16, torch.float16)
           for d in (64, 128)]
          + [((torch.float32, d), "cc") for d in (64, 128, 32, 256)]
          + [((torch.bfloat16, d), "cc") for d in (32, 96, 160, 256)])


@pytest.mark.parametrize("key,route", ROUTES,
                         ids=[f"{dt}-{d}".replace("torch.", "")
                              for (dt, d), _ in ROUTES])
def test_paged_rows_route_rule(key, route):
    dtype, d = key
    assert pa.paged_rows_route(dtype, d) == route
    # the wrapper's route: the rule by default; the CUDA-core walk takes
    # every shape; the tensor-core walk only its own
    q = torch.empty(1, 2, 1, d, dtype=dtype)

    def pick(name, r):
        return tk.pick_route(name, q, r, pa.paged_rows_route(dtype, d))

    assert pick("paged_prefill", None) == route
    assert pick("paged_verify", "cc") == "cc"
    if route == "tc":
        assert pick("paged_verify", "tc") == "tc"
    else:
        with pytest.raises(ValueError, match="paged_prefill: route 'tc'"):
            pick("paged_prefill", "tc")


@pytest.mark.parametrize("max_blocks,bs,want", [
    (32, 64, 8), (64, 64, 8), (16, 64, 4), (8, 64, 2), (4, 64, 1),
    (2, 16, 1), (256, 8, 8), (16, 32, 2)])
def test_rows_max_splits_from_the_table_width(max_blocks, bs, want):
    """One split per four KV tiles the table reaches, 1 to 8: 8 at the
    serving shape (max_seq 2048, block 64)."""
    assert pa.rows_max_splits(max_blocks, bs) == want


@pytest.mark.parametrize("max_splits", [1, 2, 3, 8])
def test_rows_split_covers_every_tile_once(max_splits):
    """Every KV tile of a row tile lies in exactly one split's range, in
    order, no range empty; a few-row lane splits in up to max_splits, a
    longer lane's row tile in up to two and only from 16 KV tiles up."""
    for n_tiles in range(0, 41):
        for few in (True, False):
            ranges = pa.rows_split(n_tiles, max_splits, few)
            covered = [t for a, b in ranges for t in range(a, b)]
            assert covered == list(range(n_tiles))
            if n_tiles:
                assert all(b > a for a, b in ranges)
            else:
                assert ranges == [(0, 0)]
            cap = max_splits if few else (min(2, max_splits)
                                          if n_tiles >= 16 else 1)
            assert len(ranges) <= cap
            if n_tiles >= cap:
                # the splits are as even as whole tiles allow
                sizes = [b - a for a, b in ranges]
                assert max(sizes) == -(-n_tiles // cap)
