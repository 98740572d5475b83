"""Distributed training of the port (counterpart of
``paddle_tpu/distributed``): the hybrid mesh over ``torch.distributed``
ranks and its differentiable collectives (:mod:`.mesh`), and fleet's
pipeline schedules and engines (:mod:`.fleet.pipeline`).  The rest of
the reference's package (fleet's eager ``PipelineLayer`` /
``PipelineParallel``, auto-parallel, checkpointing, the launcher) is not
ported yet (ROADMAP A11, A12)."""

from .mesh import (AXES, COUNTERS, Mesh, all_gather, all_to_all,  # noqa: F401
                   copy_to, exchange, ppermute, psum, reduce_scatter,
                   shard_leaf, unshard_leaf)
