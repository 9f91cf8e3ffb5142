"""Megatron tensor parallelism: the two collectives of a column-parallel /
row-parallel layer pair (port of the ``tp`` rule of
``latte_tpu/dist/sharding.py``, whose GSPMD partitioning inserts them).

A block's attention and its MLP are each a column-parallel layer (``qkv``,
``fc1``: a tp rank computes its heads or its MLP columns from the whole
input) followed by a row-parallel one (``proj``, ``fc2``: the rank's part of
the input axis gives a partial product). Exactly one all-reduce follows each
pair in the forward, and one precedes it in the backward:

- :func:`tp_enter` (Megatron's "f"): identity forward; the backward
  all-reduces (sums) the input gradient over ``tp``, since each rank's
  column-parallel layer gives only its heads' or columns' share of it.
  Without it the gradients of everything before the layer (LayerNorm, adaLN,
  the embedders) are wrong on every rank, while the block weights look right;
- :func:`tp_reduce` (Megatron's "g"): all-reduce (sum) of the row-parallel
  partial products forward; the gradient passes through unchanged.

The layers keep their local partial product apart from these collectives
(``Attention.partial``, ``Mlp.partial``), and the block calls the two
(``AdaLNBlock._row_parallel``): so a block's tp shards can also run in turn
in one process with the sum taken by hand (:func:`virtual_tp`), which is how
one GPU holds the tp path to the whole block.

:func:`tp_amax` is the third collective: the dynamic int8 path
(``quantized: true``) takes a per-token amax over a row-parallel layer's
input axis, which GSPMD computes over the whole row; under tp it is the MAX
over the ranks' parts. (A static per-tensor scale needs nothing.)
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["tp_enter", "tp_reduce", "tp_amax", "virtual_tp"]


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient all-reduced (summed) over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _traced_all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """The all-reduce as a functional collective, which ``torch.export``
    records as a graph node (an in-place ``dist.all_reduce`` it cannot
    trace); ``group`` may be a process group's name, as in an exported
    serving step (``serve.aot``), which names it at load time."""
    from torch.distributed import _functional_collectives as fc

    return fc.all_reduce(x, op, group if isinstance(group, str) else group.group_name)


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel layer (see the module docstring); the
    identity without a group (and in an export, which has no backward)."""
    return x if group is None or torch.compiler.is_exporting() else _Enter.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' row-parallel partial products (see the module
    docstring); ``x`` itself without a group. In an export, the functional
    all-reduce (the same sum)."""
    if group is None:
        return x
    if torch.compiler.is_exporting():
        return _traced_all_reduce(x, "sum", group)
    return _Reduce.apply(x, group)


def tp_amax(amax: torch.Tensor, group) -> torch.Tensor:
    """A per-token amax over a row-parallel input's part, made the amax of
    the whole row (MAX over ``group``; nothing without one). Not
    differentiable: the dynamic int8 path has no gradient."""
    if group is None:
        return amax
    if torch.compiler.is_exporting():
        return _traced_all_reduce(amax, "max", group)
    amax = amax.contiguous().clone()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return amax


def virtual_tp(blocks: List[nn.Module]) -> Optional[nn.Module]:
    """Join the tp shards of one block, built at ``tensor_parallel = len(
    blocks)`` without a process group (each holding its rank's part of the
    weights), into one process: the first shard's forward then runs every
    shard's attention and MLP partial products in turn and sums them by hand
    where ``tp_reduce`` would all-reduce them. Its replicated weights
    (adaLN, the row-parallel biases) serve; the others' are not read.
    Autograd sums the input gradients of the shards where ``tp_enter``
    would all-reduce them. Returns the first shard."""
    for b in blocks:
        if b.tp != len(blocks) or b.tp_mesh is not None:
            raise ValueError("virtual_tp needs the shards of tensor_parallel = len(blocks), without a group")
    blocks[0].tp_peers = list(blocks)
    return blocks[0]
