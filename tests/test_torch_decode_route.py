"""The fused decode steps' route rule, without a card.

``decode_route`` picks the hand-written kernel the fused decode step over
fp pools (B7) and over int8 / int4 pools (B11) launches, from (dtype,
head_dim) alone: the tensor-core ``csrc/fused_decode_tc.cu`` for bf16/f16
q at head_dim 64 or 128, the CUDA-core ``csrc/fused_decode.cu`` /
``csrc/fused_quant_decode.cu`` for every other shape.  The kernels
themselves are checked on the card (``tests/test_torch_cuda.py``).
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
def test_decode_route_rule(key, route):
    dtype, d = key
    assert pa.decode_route(dtype, d) == route
    # the wrappers' route: the rule by default; the CUDA-core kernels take
    # every shape; the tensor-core kernel only its own
    q = torch.empty(1, 2, d, dtype=dtype)

    def pick(name, r):
        return tk.pick_route(name, q, r, pa.decode_route(dtype, d))

    for name in ("fused_decode_step", "fused_quant_decode_step"):
        assert pick(name, None) == route
        assert pick(name, "cc") == "cc"
        if route == "tc":
            assert pick(name, "tc") == "tc"
        else:
            with pytest.raises(ValueError, match=f"{name}: route 'tc'"):
                pick(name, "tc")


def test_decode_tc_counters_sit_beside_the_totals():
    """Each fused decode step has a tensor-core counter beside its total,
    and a reset zeroes both."""
    for name in ("fused_decode_step", "fused_quant_decode_step"):
        assert name in tk.LAUNCHES and f"{name}_tc" in tk.LAUNCHES
        tk.LAUNCHES[f"{name}_tc"] += 1
    tk.reset_counters()
    assert not any(tk.LAUNCHES.values())
