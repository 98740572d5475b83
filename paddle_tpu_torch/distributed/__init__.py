"""Distributed training of the port (counterpart of
``paddle_tpu/distributed``): the hybrid mesh over ``torch.distributed``
ranks and its differentiable collectives (:mod:`.mesh`).  The rest of the
reference's package (fleet's pipeline schedules, auto-parallel,
checkpointing, the launcher) is not ported yet (ROADMAP A11)."""

from .mesh import (AXES, COUNTERS, Mesh, all_gather, all_to_all,  # noqa: F401
                   copy_to, ppermute, psum, reduce_scatter, shard_leaf,
                   unshard_leaf)
