"""Multi-GPU training and sampling over ``torch.distributed`` (port of
``latte_tpu/dist``): the process group and the (dp, ep, sp, tp, pp) mesh
(:mod:`.mesh`), where each parameter, moment and EMA entry lives
(:mod:`.sharding`), Megatron's tensor-parallel collectives (:mod:`.tp`),
the sequence-parallel relayouts (:mod:`.seq`), ring attention
(:mod:`.ring`) and the GPipe schedule of pipeline parallelism with the
pipelined forwards (:mod:`.pipeline`)."""

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
from latte_tpu_torch.dist.pipeline import (
    LocalHop,
    P2PHop,
    gpipe,
    make_pipelined_apply,
    pipelined_latte_forward,
    pipelined_latte_img_forward,
    pipelined_t2v_forward,
)

__all__ = [
    "DistContext", "LocalHop", "MeshConfig", "P2PHop", "barrier", "batch_rows", "gpipe", "initialize_distributed",
    "is_main_process", "make_mesh", "make_pipelined_apply", "pipelined_latte_forward", "pipelined_latte_img_forward",
    "pipelined_t2v_forward", "setup", "shard_batch",
]
