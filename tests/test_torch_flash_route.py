"""The flash forward's, dK/dV's and dQ's route rule, without a card.

``flash_route`` picks the hand-written kernel the CUDA wrappers launch from
(dtype, head_dim) alone: the wgmma tensor-core kernels for bf16/f16 at
head_dim 64 or 128, the f32 CUDA-core kernels for every other shape the
wrappers take.  A plain function, so it is checked here; the kernels
themselves are checked on the card (``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401

ROUTES = ([((dt, d), "tc") for dt in (torch.bfloat16, torch.float16)
           for d in (64, 128)]
          + [((torch.float32, d), "cc") for d in (64, 128, 40, 256)]
          + [((dt, d), "cc") for dt in (torch.bfloat16, torch.float16)
             for d in (8, 40, 96, 256)])


@pytest.mark.parametrize("key,route", ROUTES,
                         ids=[f"{dt}-{d}".replace("torch.", "")
                              for (dt, d), _ in ROUTES])
def test_flash_route_rule(key, route):
    dtype, d = key
    assert tfa.flash_route(dtype, d) == route
    q = torch.empty(1, 2, 1, d, dtype=dtype)
    # the wrappers' route: the rule by default; the CUDA-core kernels take
    # every shape; the tensor-core kernels only theirs
    assert tfa._pick_route("flash_fwd", q, None) == route
    assert tfa._pick_route("flash_fwd", q, "cc") == "cc"
    if route == "tc":
        assert tfa._pick_route("flash_dkv", q, "tc") == "tc"
    else:
        with pytest.raises(ValueError, match="route 'tc'"):
            tfa._pick_route("flash_dkv", q, "tc")


@pytest.mark.parametrize("key,route", ROUTES,
                         ids=[f"{dt}-{d}".replace("torch.", "")
                              for (dt, d), _ in ROUTES])
def test_flash_dq_route_follows_the_rule(key, route):
    """dQ takes the same rule as the forward and dK/dV: the tensor-core
    kernel by default where the rule names it, the CUDA-core one on
    request, and "tc" refused for every other shape."""
    dtype, d = key
    q = torch.empty(1, 2, 1, d, dtype=dtype)
    assert tfa._pick_route("flash_dq", q, None) == route
    assert tfa._pick_route("flash_dq", q, "cc") == "cc"
    if route == "tc":
        assert tfa._pick_route("flash_dq", q, "tc") == "tc"
    else:
        with pytest.raises(ValueError, match="flash_dq: route 'tc'"):
            tfa._pick_route("flash_dq", q, "tc")
