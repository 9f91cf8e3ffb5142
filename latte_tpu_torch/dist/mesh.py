"""Process group, device mesh and the rows of a rank (port of
``latte_tpu/dist/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets XLA
insert the collectives; here one process drives one GPU and the collectives
are ``torch.distributed``'s (NCCL on the card, gloo when the caller asked
for the CPU). The mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh`
with the JAX axis order, ``dp`` outermost, then ``ep``: rank = dp_rank·ep +
ep_rank. The batch is split over ``dp`` and replicated over ``ep``, as the
JAX batch is ``P("dp")``.

Axes:
  - ``dp``: data parallel (batch rows; under ``fsdp`` also the block weights,
    their EMA and their moments; under ``zero1`` the moments).
  - ``ep``: expert parallel (the expert axis of the MoE weights,
    ``models/moe.py``).
  - ``tp``, ``sp``, ``pp`` (tensor, sequence and pipeline parallelism) are
    not ported yet: above 1 they raise ``NotImplementedError`` naming
    ROADMAP M6b.

Processes meet through :func:`initialize_distributed`: torchrun's
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``, or
the config's ``coordinator_address``, ``num_processes`` and ``process_id``
(the JAX trainer's keys). Each process takes the GPU ``LOCAL_RANK``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from latte_tpu_torch.utils import resolve_device

__all__ = [
    "M6B", "MeshConfig", "DistContext", "make_mesh", "initialize_distributed", "setup",
    "is_main_process", "barrier", "batch_rows", "shard_batch",
]

M6B = "the multi-GPU slice's second half (ROADMAP M6b)"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1  # -1: every device the other axes leave
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        denom = self.tp * self.sp * self.pp * self.ep
        dp = self.dp if self.dp != -1 else n_devices // denom
        if dp * denom != n_devices:
            raise AssertionError(
                f"mesh dp{dp}xep{self.ep}xsp{self.sp}xtp{self.tp}xpp{self.pp} != {n_devices} devices"
            )
        return MeshConfig(dp=dp, tp=self.tp, sp=self.sp, pp=self.pp, ep=self.ep)


def refuse_m6b(tp: int = 1, sp: int = 1, pp: int = 1) -> None:
    """``NotImplementedError`` naming M6b for a tensor, sequence or pipeline
    axis above 1."""
    for key, n in (("tensor_parallel", tp), ("sequence_parallel", sp), ("pipeline_parallel", pp)):
        if n > 1:
            raise NotImplementedError(f"{key}={n}: not ported yet; comes with {M6B}")


def make_mesh(config: MeshConfig = MeshConfig(), device_type: str = "cuda"):
    """The (dp, ep) ``DeviceMesh`` over every rank of the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    refuse_m6b(config.tp, config.sp, config.pp)
    cfg = config.resolve(dist.get_world_size())
    return init_device_mesh(device_type, (cfg.dp, cfg.ep), mesh_dim_names=("dp", "ep"))


@dataclasses.dataclass
class DistContext:
    """This process's place in the mesh: its device, its dp and ep indices
    and the groups of its two axes."""

    mesh: object  # DeviceMesh
    device: torch.device

    def __deepcopy__(self, memo):
        return self  # a copied model (the EMA) shares the process groups

    @property
    def world(self) -> int:
        return self.mesh.size()

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def dp(self) -> int:
        return self.mesh.size(0)

    @property
    def ep(self) -> int:
        return self.mesh.size(1)

    @property
    def dp_rank(self) -> int:
        return self.mesh.get_local_rank("dp")

    @property
    def ep_rank(self) -> int:
        return self.mesh.get_local_rank("ep")

    @property
    def dp_group(self):
        return self.mesh.get_group("dp")

    @property
    def ep_group(self):
        return self.mesh.get_group("ep")

    @property
    def world_group(self):
        return dist.group.WORLD


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
) -> Optional[torch.device]:
    """Join the process group; return this rank's device, or None for a
    single process (no torchrun environment, ``num_processes`` unset or 1,
    no group yet). NCCL on the card (after ``torch.cuda.set_device(
    LOCAL_RANK)``, before any CUDA tensor), gloo only when ``device`` is
    the CPU; without a GPU and without ``device='cpu'`` it raises, as every
    entry point does. An existing group is joined as it is."""
    env = os.environ
    if dist.is_available() and dist.is_initialized():
        return resolve_device(device)
    if int(env.get("WORLD_SIZE", "1") or 1) > 1 and "RANK" not in env:
        raise RuntimeError(
            f"WORLD_SIZE={env['WORLD_SIZE']} but no RANK: launch one process per GPU with torchrun "
            "(or set RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT)"
        )
    if "WORLD_SIZE" in env and "RANK" in env:
        init, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    elif num_processes is not None and int(num_processes) > 1:
        if not coordinator_address or process_id is None:
            raise ValueError(
                f"num_processes={num_processes} needs coordinator_address (host:port) and process_id"
            )
        init, world, rank = f"tcp://{coordinator_address}", int(num_processes), int(process_id)
        if "LOCAL_RANK" not in env and torch.cuda.is_available():
            env["LOCAL_RANK"] = str(rank % torch.cuda.device_count())
    else:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init, world_size=world, rank=rank)
    return dev


def setup(config, device: Optional[str] = None, check=None):
    """``(device, ctx)`` for an entry point: the rendezvous of
    :func:`initialize_distributed` from the config's keys, ``check(world
    size)`` (the entry point's own validation), then the mesh of its
    ``expert_parallel`` (the M6b axes raise). A single process gets
    ``(resolve_device(device), None)``."""
    dev = initialize_distributed(
        getattr(config, "coordinator_address", None),
        getattr(config, "num_processes", None),
        getattr(config, "process_id", None),
        device,
    )
    if check is not None:
        check(1 if dev is None else dist.get_world_size())
    if dev is None:
        return resolve_device(device), None
    mesh = make_mesh(
        MeshConfig(
            tp=int(getattr(config, "tensor_parallel", 1) or 1),
            sp=int(getattr(config, "sequence_parallel", 1) or 1),
            pp=int(getattr(config, "pipeline_parallel", 1) or 1),
            ep=int(getattr(config, "expert_parallel", 1) or 1),
        ),
        dev.type,
    )
    return dev, DistContext(mesh, dev)


def is_main_process() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def barrier() -> None:
    """Every rank waits here (the reference's ``dist.barrier()`` around its
    checkpoints); nothing in a single process."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def batch_rows(n_local: int, ctx: Optional[DistContext]) -> slice:
    """This rank's rows of a global batch of ``n_local·dp`` rows: the block
    of its dp index (the ranks of one ep group share it)."""
    if ctx is None:
        return slice(0, n_local)
    return slice(ctx.dp_rank * n_local, (ctx.dp_rank + 1) * n_local)


def shard_batch(batch: dict, ctx: Optional[DistContext]) -> dict:
    """The counterpart of the JAX ``shard_batch``: this rank's rows of a
    global host batch (every array's leading axis split over dp)."""
    if ctx is None:
        return batch
    return {k: v[batch_rows(v.shape[0] // ctx.dp, ctx)] for k, v in batch.items()}
