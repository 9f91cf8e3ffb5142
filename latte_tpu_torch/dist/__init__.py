"""Multi-GPU training and sampling over ``torch.distributed`` (port of
``latte_tpu/dist``): the process group and the (dp, ep, sp, tp) mesh
(:mod:`.mesh`), where each parameter, moment and EMA entry lives
(:mod:`.sharding`), Megatron's tensor-parallel collectives (:mod:`.tp`),
the sequence-parallel relayouts (:mod:`.seq`) and ring attention
(:mod:`.ring`)."""

from latte_tpu_torch.dist.mesh import (
    DistContext,
    MeshConfig,
    barrier,
    batch_rows,
    initialize_distributed,
    is_main_process,
    make_mesh,
    setup,
    shard_batch,
)

__all__ = [
    "DistContext", "MeshConfig", "barrier", "batch_rows", "initialize_distributed",
    "is_main_process", "make_mesh", "setup", "shard_batch",
]
