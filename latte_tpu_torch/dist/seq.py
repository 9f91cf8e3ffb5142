"""Sequence parallelism: the model's fused batch·token rows split over the
``sp`` ranks (port of the JAX model's ``activation_sharding``,
``latte_tpu/models/dit.py:18-24, 78, 91-95``).

The spatial blocks see the (b f) rows of the rank's dp share of the batch,
(B·F, T, D), the temporal blocks its (b t) rows, (B·T, F, D). Each sp rank
holds a contiguous block of each fused axis, rank s the rows [s·R/sp,
(s+1)·R/sp), as ``P(("dp", "sp"))`` lays them out. The relayout between the
two layouts is then one all-to-all over the sp group each way (what GSPMD
compiles the JAX relayouts to): each rank sends every other rank the (b, f,
t) elements it holds in one layout and the other rank holds in the other,
in the order the receiver stores them (:class:`Relayout`). When the rank's
rows are whole videos (B divisible by sp) nothing crosses between ranks.

:func:`gather_rows` all-gathers the rows at the end, so the output
projection's unpatchify and the loss see the whole video on every sp rank.
Its backward hands each rank its rows of the (equal) whole gradient times
sp: the reduce-scatter of sp equal gradients, without the traffic. Every
gradient a rank then computes is sp times its rows' share, and averaging
over sp (as the parameters are replicated over sp) gives the whole.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.distributed as dist

__all__ = ["Relayout", "gather_rows", "local_rows"]


def local_rows(n: int, sp: int, rank: int) -> slice:
    """Rank ``rank``'s block of ``n`` fused rows."""
    if n % sp:
        raise ValueError(f"sequence_parallel={sp} does not divide the {n} fused batch·token rows")
    m = n // sp
    return slice(rank * m, (rank + 1) * m)


@functools.lru_cache(maxsize=64)
def _plan(B: int, F: int, T: int, sp: int, rank: int, to_temporal: bool):
    """Index plan of one relayout on one rank: (send order, send counts,
    receive positions, receive counts) over the flat (rows·tokens) elements
    of the rank's block. Spatial element (b, f, t) sits at row b·F + f,
    token t; temporal at row b·T + t, token f."""
    b, f, t = torch.meshgrid(torch.arange(B), torch.arange(F), torch.arange(T), indexing="ij")
    b, f, t = b.reshape(-1), f.reshape(-1), t.reshape(-1)
    rs, rt = B * F // sp, B * T // sp  # rows a rank holds in each layout
    i, j = b * F + f, b * T + t
    src = (i // rs, (i % rs) * T + t)  # (owner, flat index in its block): spatial
    dst = (j // rt, (j % rt) * F + f)  # the same in the temporal layout
    if not to_temporal:
        src, dst = dst, src
    mine = src[0] == rank
    order = torch.argsort(dst[0][mine] * (B * F * T) + dst[1][mine])
    send = src[1][mine][order]
    send_counts = torch.bincount(dst[0][mine], minlength=sp).tolist()
    into = dst[0] == rank
    order = torch.argsort(src[0][into] * (B * F * T) + dst[1][into])
    recv = dst[1][into][order]
    recv_counts = torch.bincount(src[0][into], minlength=sp).tolist()
    return send, send_counts, recv, recv_counts


class _AllToAll(torch.autograd.Function):
    """``x`` (elements, D) in the order ``send`` to the ranks' counts;
    returns the received rows placed at ``recv``. The backward is the same
    exchange the other way."""

    @staticmethod
    def forward(ctx, x, plan, group):
        ctx.plan, ctx.group = plan, group
        return _exchange(x, *plan, group)

    @staticmethod
    def backward(ctx, grad):
        send, send_counts, recv, recv_counts = ctx.plan
        return _exchange(grad, recv, recv_counts, send, send_counts, ctx.group), None, None


def _exchange(x, send, send_counts, recv, recv_counts, group):
    send, recv = send.to(x.device), recv.to(x.device)
    buf = x.index_select(0, send)
    got = x.new_empty((sum(recv_counts), x.shape[1]))
    dist.all_to_all_single(got, buf, recv_counts, send_counts, group=group)
    out = x.new_empty((recv.numel(), x.shape[1]))
    out.index_copy_(0, recv, got)
    return out


class Relayout:
    """The (b f) t d <-> (b t) f d relayouts of a rank's rows over the sp
    group of ``ctx`` (B videos of F frames of T tokens)."""

    def __init__(self, ctx, B: int, F: int, T: int):
        self.group, self.sp, self.rank = ctx.sp_group, ctx.sp, ctx.sp_rank
        self.B, self.F, self.T = B, F, T
        local_rows(B * F, self.sp, 0)
        local_rows(B * T, self.sp, 0)

    def to_temporal(self, x: torch.Tensor) -> torch.Tensor:
        """(B·F/sp, T, D) -> (B·T/sp, F, D)."""
        return self._move(x, True, (self.B * self.T // self.sp, self.F))

    def to_spatial(self, x: torch.Tensor) -> torch.Tensor:
        """(B·T/sp, F, D) -> (B·F/sp, T, D)."""
        return self._move(x, False, (self.B * self.F // self.sp, self.T))

    def _move(self, x: torch.Tensor, to_temporal: bool, shape: Tuple[int, int]) -> torch.Tensor:
        D = x.shape[-1]
        plan = _plan(self.B, self.F, self.T, self.sp, self.rank, to_temporal)
        out = _AllToAll.apply(x.reshape(-1, D), plan, self.group)
        return out.view(*shape, D)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sp, rank):
        ctx.sp, ctx.rank = sp, rank
        parts = [torch.empty_like(x) for _ in range(sp)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[0] // ctx.sp
        return grad[ctx.rank * n:(ctx.rank + 1) * n] * ctx.sp, None, None, None


def gather_rows(x: torch.Tensor, ctx) -> torch.Tensor:
    """Every sp rank's block of rows, whole (see the module docstring)."""
    return _GatherRows.apply(x, ctx.sp_group, ctx.sp, ctx.sp_rank)
