"""The weight bridge (``paddle_tpu_torch.utils.convert``): a JAX parameter
tree goes leaf by leaf through numpy into torch and back bit-exactly, bf16
(an ml_dtypes array on the JAX side) and f32 alike."""

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu_torch.utils import convert
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dtype,tdtype", [(jnp.bfloat16, torch.bfloat16),
                                          (jnp.float32, torch.float32)])
def test_param_tree_round_trip_is_exact(dtype, tdtype):
    rs = np.random.RandomState(5)

    def leaf(*shape):
        return jnp.asarray(rs.randn(*shape) * 0.02, dtype)

    # a Llama-shaped tree: stacked [L, in, out] layer weights, norms, head
    jtree = {"embed": leaf(32, 16), "final_norm": jnp.ones((16,), dtype),
             "lm_head": leaf(16, 32),
             "layers": {"input_norm": jnp.ones((2, 16), dtype),
                        "wq": leaf(2, 16, 16), "w_down": leaf(2, 24, 16)}}
    tree = jax.tree_util.tree_map(np.asarray, jtree)
    tparams = convert.params_from_numpy(tree, device="cpu")
    assert tparams["layers"]["wq"].dtype == tdtype
    back = convert.params_to_numpy(tparams)
    flat, _ = jax.tree_util.tree_flatten(tree)
    flat_back, _ = jax.tree_util.tree_flatten(back)
    for a, b in zip(flat, flat_back):
        if a.dtype == ml_dtypes.bfloat16:
            np.testing.assert_array_equal(a.view(np.uint16), b)
            # the bits are the values: back through ml_dtypes unchanged
            assert (b.view(ml_dtypes.bfloat16) == a).all()
        else:
            np.testing.assert_array_equal(a, b)
    # the torch values equal the JAX values
    wq = tree["layers"]["wq"].astype(np.float32)
    np.testing.assert_array_equal(tparams["layers"]["wq"].float().numpy(), wq)


def test_pools_and_tables_convert():
    """State for the engine comparisons: a bf16 pool and int32 tables."""
    rs = np.random.RandomState(0)
    pool = jnp.asarray(rs.randn(3, 2, 4, 8), jnp.bfloat16)
    table = np.arange(6, dtype=np.int32).reshape(2, 3)
    got = convert.params_from_numpy({"pool": pool, "table": table},
                                   device="cpu")
    assert got["pool"].dtype == torch.bfloat16
    assert got["table"].dtype == torch.int32
    np.testing.assert_array_equal(got["pool"].float().numpy(),
                                  np.asarray(pool.astype(jnp.float32)))
    np.testing.assert_array_equal(got["table"].numpy(), table)
    with pytest.raises(TypeError):
        convert.tensor_from_numpy(np.zeros(2, np.complex64), device="cpu")


def test_default_device_is_the_card():
    """Naming no device puts the tensors on the CUDA card; with no card the
    bridge raises instead of dropping to the CPU."""
    tree = {"w": np.ones((2, 3), np.float32)}
    if torch.cuda.is_available():
        assert convert.params_from_numpy(tree)["w"].device.type == "cuda"
        assert convert.tensor_from_numpy(tree["w"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.params_from_numpy(tree)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert.tensor_from_numpy(tree["w"])
