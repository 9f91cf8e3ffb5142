"""Process group, device mesh and the rows of a rank (port of
``latte_tpu/dist/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets XLA
insert the collectives; here one process drives one GPU and the collectives
are ``torch.distributed``'s (NCCL on the card, gloo when the caller asked
for the CPU). The mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh`
with the JAX axis order ``dp, ep, sp, tp, pp``, ``dp`` outermost and ``pp``
innermost (the JAX mesh's order, ``latte_tpu/dist/mesh.py:61-77``): rank =
(((dp_rank·ep + ep_rank)·sp + sp_rank)·tp + tp_rank)·pp + pp_rank. The batch
is split over ``dp`` and replicated over ``ep``, ``sp``, ``tp`` and ``pp``,
as the JAX batch is ``P("dp")``. With ``pp`` innermost the stages of one dp
row are consecutive ranks, and ranks 0..pp-1 hold dp index 0 of each stage.

Axes:
  - ``dp``: data parallel (batch rows; under ``fsdp`` also the block weights,
    their EMA and their moments; under ``zero1`` the moments).
  - ``ep``: expert parallel (the expert axis of the MoE weights,
    ``models/moe.py``).
  - ``sp``: sequence parallel (the fused batch·token rows of the model's
    activations, ``models/dit.py``; and the ring of ring attention,
    ``dist/ring.py``).
  - ``tp``: tensor parallel (attention heads and MLP columns of the blocks,
    ``dist/tp.py``).
  - ``pp``: pipeline parallel (the model's depth: stage ``pp_rank`` holds
    its ``n_pairs / pp`` block pairs, ``dist/pipeline.py``; its hops go to
    the global ranks ``pp_prev`` and ``pp_next``).

:meth:`DistContext.group` gives the process group of any set of axes (the
ranks that differ only along them), which the step's collectives average
over.

Processes meet through :func:`initialize_distributed`: torchrun's
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``, or
the config's ``coordinator_address``, ``num_processes`` and ``process_id``
(the JAX trainer's keys). Each process takes the GPU ``LOCAL_RANK``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from latte_tpu_torch.utils import resolve_device

__all__ = [
    "AXES", "MeshConfig", "DistContext", "make_mesh", "initialize_distributed", "setup",
    "is_main_process", "barrier", "batch_rows", "shard_batch",
]

AXES = ("dp", "ep", "sp", "tp", "pp")


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


def make_mesh(config: MeshConfig = MeshConfig(), device_type: str = "cuda"):
    """The (dp, ep, sp, tp, pp) ``DeviceMesh`` over every rank of the
    process group (an axis of size 1 included)."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = config.resolve(dist.get_world_size())
    return init_device_mesh(device_type, (cfg.dp, cfg.ep, cfg.sp, cfg.tp, cfg.pp), mesh_dim_names=AXES)


@dataclasses.dataclass
class DistContext:
    """This process's place in the mesh: its device, its index on each axis
    (``dp_rank``, ...), and the groups of the axes and of their unions
    (:meth:`group`), made once here, as every rank must make each group."""

    mesh: object  # DeviceMesh
    device: torch.device
    # the local batch is the [cond | uncond] halves of this rank's rows, and
    # the global batch [cond | uncond] of every rank's (the samplers' CFG doubling)
    cfg_halves: bool = False
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        sizes = dict(zip(AXES, self.mesh.shape))
        live = [a for a in AXES if sizes[a] > 1]
        ranks = torch.arange(self.world).view(*self.mesh.shape)
        for n in range(2, len(live) + 1):
            for axes in itertools.combinations(live, n):
                if n == len(live):
                    self.groups[axes] = dist.group.WORLD
                    continue
                # the ranks that differ only along `axes`: those axes last, flattened
                keep = [AXES.index(a) for a in AXES if a not in axes]
                move = [AXES.index(a) for a in axes]
                members = ranks.permute(*keep, *move).reshape(-1, _prod(sizes[a] for a in axes))
                mine, _ = dist.new_subgroups_by_enumeration(members.tolist())
                self.groups[axes] = mine

    def __deepcopy__(self, memo):
        return self  # a copied model (the EMA) shares the process groups

    def size(self, *axes: str) -> int:
        """The number of ranks along ``axes`` together."""
        return _prod(self.mesh.size(AXES.index(a)) for a in axes)

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only
        along ``axes``, or None when that is this rank alone."""
        live = tuple(a for a in AXES if a in axes and self.size(a) > 1)
        if not live:
            return None
        if len(live) == 1:
            return self.mesh.get_group(live[0])
        return self.groups[live]

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
    def sp(self) -> int:
        return self.mesh.size(2)

    @property
    def tp(self) -> int:
        return self.mesh.size(3)

    @property
    def pp(self) -> int:
        return self.mesh.size(4)

    @property
    def dp_rank(self) -> int:
        return self.mesh.get_local_rank("dp")

    @property
    def ep_rank(self) -> int:
        return self.mesh.get_local_rank("ep")

    @property
    def sp_rank(self) -> int:
        return self.mesh.get_local_rank("sp")

    @property
    def tp_rank(self) -> int:
        return self.mesh.get_local_rank("tp")

    @property
    def pp_rank(self) -> int:
        return self.mesh.get_local_rank("pp")

    @property
    def dp_group(self):
        return self.mesh.get_group("dp")

    @property
    def ep_group(self):
        return self.mesh.get_group("ep")

    @property
    def sp_group(self):
        return self.mesh.get_group("sp")

    @property
    def tp_group(self):
        return self.mesh.get_group("tp")

    @property
    def pp_group(self):
        return self.mesh.get_group("pp")

    def stage_rank(self, stage: int) -> int:
        """The global rank of pipeline stage ``stage`` in this rank's dp row
        (``pp`` is the innermost axis)."""
        return self.rank - self.pp_rank + stage

    @property
    def pp_prev(self) -> Optional[int]:
        """The global rank of the previous stage (None on stage 0)."""
        return self.stage_rank(self.pp_rank - 1) if self.pp_rank > 0 else None

    @property
    def pp_next(self) -> Optional[int]:
        """The global rank of the next stage (None on the last)."""
        return self.stage_rank(self.pp_rank + 1) if self.pp_rank < self.pp - 1 else None

    # the rows of the model's activations: split over dp, then sp
    # (P(("dp", "sp")) of the JAX model's activation sharding)

    @property
    def rows(self) -> int:
        return self.dp * self.sp

    @property
    def row_rank(self) -> int:
        return self.dp_rank * self.sp + self.sp_rank

    @property
    def row_group(self):
        return self.group("dp", "sp")

    def token_segments(self, n: int, row_rank: Optional[int] = None):
        """Where the ``n`` tokens of row rank ``row_rank`` (default this
        rank's) sit in the global token order: ``[(global start, local
        start, length)]``, one segment, or two under ``cfg_halves``."""
        r = self.row_rank if row_rank is None else row_rank
        if not self.cfg_halves:
            return [(r * n, 0, n)]
        half = n // 2
        return [(r * half, 0, half), ((self.rows + r) * half, half, half)]

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


def _prod(values) -> int:
    n = 1
    for v in values:
        n *= v
    return n


def setup(config, device: Optional[str] = None, check=None, mesh: Optional[MeshConfig] = None):
    """``(device, ctx)`` for an entry point: the rendezvous of
    :func:`initialize_distributed` from the config's keys, ``check(world
    size)`` (the entry point's own validation), then the mesh of its
    ``expert_parallel``, ``sequence_parallel``, ``tensor_parallel`` and
    ``pipeline_parallel`` (or ``mesh``). A single process gets
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
    if mesh is None:
        mesh = MeshConfig(
            tp=int(getattr(config, "tensor_parallel", 1) or 1),
            sp=int(getattr(config, "sequence_parallel", 1) or 1),
            pp=int(getattr(config, "pipeline_parallel", 1) or 1),
            ep=int(getattr(config, "expert_parallel", 1) or 1),
        )
    return dev, DistContext(make_mesh(mesh, dev.type), dev)


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
    of its dp index (the ranks of one ep, sp, tp or pp group share it)."""
    if ctx is None:
        return slice(0, n_local)
    return slice(ctx.dp_rank * n_local, (ctx.dp_rank + 1) * n_local)


def shard_batch(batch: dict, ctx: Optional[DistContext]) -> dict:
    """The counterpart of the JAX ``shard_batch``: this rank's rows of a
    global host batch (every array's leading axis split over dp)."""
    if ctx is None:
        return batch
    return {k: v[batch_rows(v.shape[0] // ctx.dp, ctx)] for k, v in batch.items()}
