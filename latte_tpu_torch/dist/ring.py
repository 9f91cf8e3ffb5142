"""Ring attention: exact attention with the token axis split over a ring of
ranks (port of ``latte_tpu/dist/ring.py``: ``_block_attn_lse`` :31,
``ring_attention`` :52, ``ring_attention_sharded`` :83).

Each rank holds one block of the queries and, in turn, every block of the
keys and values: K/V rotate one hop around the ring a step
(``batch_isend_irecv``). The forward runs the flash-attention kernel (B1)
with its logsumexp on each (Q block, K/V block) pair and merges the
normalised partial outputs in fp32 by ``logaddexp``, as the JAX ring does:
``out' = Σ out_j · exp(lse_j − lse')``. The N×N scores never exist whole.

The backward is one ``torch.autograd.Function`` for the whole ring (the
JAX ring differentiates its einsums; the port runs the hand-written
kernels, which compute the same function). It hands the backward kernels B4
(dQ) and B5 (dK, dV) the merged output's global logsumexp and ``delta =
rowsum(dO·O)`` of the merged output: with the global lse each block's P is
the true softmax restricted to that block, so the per-block gradients sum to
the whole one. dQ sums over the blocks in fp32 on its rank; each K/V block's
dK/dV accumulate in fp32 as they travel the ring with the block and take one
more hop back to their owner.

:func:`ring_attention` runs on this rank's blocks; :func:`ring_attention_
sharded` takes whole q, k, v (the same on every rank of the ring, as the
model's activations are), runs the rank's query block and all-gathers the
output (and, in the backward, the gradients). :func:`virtual_ring_attention`
runs the same schedule for every rank in turn in one process: one GPU holds
the ring's arithmetic to the whole-sequence kernels with it.

The ring of a :class:`~latte_tpu_torch.dist.mesh.DistContext` is its ``sp``
group; a process group is its own ring.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from latte_tpu_torch.kernels.attention import (
    attention_delta,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)

__all__ = ["ring_group", "ring_size", "ring_attention", "ring_attention_sharded", "virtual_ring_attention"]


def ring_group(mesh):
    """The process group of the ring: a ``DistContext``'s ``sp`` group (None
    at sp = 1), or ``mesh`` itself when it is a process group."""
    if hasattr(mesh, "sp_group"):
        return mesh.sp_group if mesh.sp > 1 else None
    return mesh


def ring_size(mesh) -> int:
    group = ring_group(mesh)
    return 1 if group is None else dist.get_world_size(group)


# -- one rank's arithmetic, shared by the ring and the virtual ring ---------

def _block(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1 on one (Q block, K/V block) pair: the normalised output and the
    fp32 (B·H, Nq) logsumexp."""
    return flash_attention(q, k, v, return_lse=True)


def _merge(acc, lse, out, lse_i):
    """Merge a block's normalised output into the fp32 accumulator (B, N,
    H, D) by the two logsumexps (B·H, N): returns the new pair."""
    B, N, H, _ = acc.shape
    lse_new = torch.logaddexp(lse, lse_i)
    to_rows = lambda t: t.view(B, H, N).permute(0, 2, 1)[..., None]  # noqa: E731
    acc = acc * to_rows(torch.exp(lse - lse_new)) + out.float() * to_rows(torch.exp(lse_i - lse_new))
    return acc, lse_new


def _block_grads(q, k, v, dout, lse, delta):
    """B4 and B5 on one pair, fed the merged lse and delta: this query
    block's share of dQ, and its shares of the K/V block's dK and dV."""
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, torch.empty_like(q))
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, torch.empty_like(k), torch.empty_like(v))
    return dq, dk, dv


def _forward_steps(q, blocks):
    """The forward over the K/V blocks in the ring's order (an iterable of
    (k, v)): the merged output in q's type and its fp32 logsumexp."""
    acc = lse = None
    for k, v in blocks:
        out, lse_i = _block(q, k, v)
        if acc is None:
            acc, lse = out.float(), lse_i
        else:
            acc, lse = _merge(acc, lse, out, lse_i)
    return acc.to(q.dtype), lse.contiguous()


# -- the ring over processes -----------------------------------------------

class _Rotate:
    """One hop around the ring: each rank sends to the next and receives
    from the previous."""

    def __init__(self, group):
        self.group = group
        ranks = dist.get_process_group_ranks(group)
        me = ranks.index(dist.get_rank())
        self.send_to, self.recv_from = ranks[(me + 1) % len(ranks)], ranks[(me - 1) % len(ranks)]
        self.index, self.n = me, len(ranks)

    def __call__(self, *tensors) -> List[torch.Tensor]:
        got = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t, self.send_to, self.group) for t in tensors]
        ops += [dist.P2POp(dist.irecv, g, self.recv_from, self.group) for g in got]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return got


def _rotating(rotate, k, v):
    """K/V blocks in the ring's order: this rank's, then each one the
    previous rank held."""
    yield k, v
    for _ in range(rotate.n - 1):
        k, v = rotate(k, v)
        yield k, v


class _Ring(torch.autograd.Function):
    """The ring on this rank's (B, N/n, H, D) blocks (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        rotate = _Rotate(group)
        k, v = k.contiguous(), v.contiguous()
        out, lse = _forward_steps(q, _rotating(rotate, k, v))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.rotate = rotate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_ring_backward(q, k, v, out, lse, dout, ctx.rotate), None)


def _ring_backward(q, k, v, out, lse, dout, rotate):
    """This rank's dQ, dK, dV of the ring (see the module docstring)."""
    dout = dout.to(q.dtype).contiguous()
    delta = attention_delta(out, dout)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for step in range(rotate.n):
        if step:  # the K/V block moves on, its gradients with it
            k, v, dk, dv = rotate(k, v, dk, dv)
        dq_i, dk_i, dv_i = _block_grads(q, k, v, dout, lse, delta)
        dq += dq_i.float()
        dk += dk_i.float()
        dv += dv_i.float()
    if rotate.n > 1:
        dk, dv = rotate(dk, dv)  # one more hop: home to the block's owner
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group) -> torch.Tensor:
    """Exact attention over the token axis split over ``group``: q, k, v are
    this rank's (B, N/n, H, D) blocks (rank i of the group holds block i);
    returns this rank's output block. Differentiable. A group of one (or
    None) is the flash-attention kernel on the one block."""
    if group is None or dist.get_world_size(group) == 1:
        return flash_attention(q, k, v)
    return _Ring.apply(q, k, v, group)


def _rows(t: torch.Tensor, index: int, n: int) -> torch.Tensor:
    m = t.shape[1] // n
    return t[:, index * m:(index + 1) * m]


def _gather_tokens(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=1)


class _RingSharded(torch.autograd.Function):
    """Whole q, k, v in, the whole output out; every rank runs its query
    block of the ring and the output blocks are all-gathered. The backward
    takes this rank's block of dO (the same on every rank) and all-gathers
    the ring's gradients, so every rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        rotate = _Rotate(group)
        i, n = rotate.index, rotate.n
        qb, kb, vb = (_rows(t, i, n).contiguous() for t in (q, k, v))
        out, lse = _forward_steps(qb, _rotating(rotate, kb, vb))
        ctx.save_for_backward(qb, kb, vb, out, lse)
        ctx.rotate, ctx.group = rotate, group
        return _gather_tokens(out, group)

    @staticmethod
    def backward(ctx, dout):
        qb, kb, vb, out, lse = ctx.saved_tensors
        rotate = ctx.rotate
        dq, dk, dv = _ring_backward(qb, kb, vb, out, lse, _rows(dout, rotate.index, rotate.n), rotate)
        return (*(_gather_tokens(g, ctx.group) for g in (dq, dk, dv)), None)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh) -> torch.Tensor:
    """Ring attention over whole (B, N, H, D) q, k, v held alike by every
    rank of the ring of ``mesh`` (see :func:`ring_group`); N must divide by
    the ring's size (``ValueError``, as in JAX). Returns the whole output on
    every rank. Differentiable."""
    group = ring_group(mesh)
    n = 1 if group is None else dist.get_world_size(group)
    if q.shape[1] % n:
        raise ValueError(f"ring attention: token axis {q.shape[1]} not divisible by the ring's size {n}")
    if n == 1:
        return flash_attention(q, k, v)
    return _RingSharded.apply(q, k, v, group)


# -- the same schedule in one process ----------------------------------------

class _VirtualRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n):
        qs, ks, vs = ([_rows(t, i, n).contiguous() for i in range(n)] for t in (q, k, v))
        outs, lses = [], []
        for r in range(n):  # rank r holds K/V block (r - step) mod n at each step
            out, lse = _forward_steps(qs[r], ((ks[(r - s) % n], vs[(r - s) % n]) for s in range(n)))
            outs.append(out)
            lses.append(lse)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.n = n
        return torch.cat(outs, dim=1)

    @staticmethod
    def backward(ctx, dout):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        dq = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in qs]
        share = {}  # (query block r, K/V block j) -> r's shares of j's dK, dV
        for r in range(n):
            do = _rows(dout, r, n).to(qs[r].dtype).contiguous()
            delta = attention_delta(outs[r], do)
            for s in range(n):
                j = (r - s) % n
                dq_i, *share[r, j] = _block_grads(qs[r], ks[j], vs[j], do, lses[r], delta)
                dq[r] += dq_i.float()
        dk, dv = [], []
        for j in range(n):  # block j's shares in the order they join it around the ring
            acc_k = torch.zeros(ks[j].shape, dtype=torch.float32, device=ks[j].device)
            acc_v = torch.zeros_like(acc_k)
            for s in range(n):
                dk_i, dv_i = share[(j + s) % n, j]
                acc_k += dk_i.float()
                acc_v += dv_i.float()
            dk.append(acc_k)
            dv.append(acc_v)
        dtype = qs[0].dtype
        return (*(torch.cat(g, dim=1).to(dtype) for g in (dq, dk, dv)), None)


def virtual_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """The ring's schedule for a ring of ``n`` run rank by rank in one
    process on whole (B, N, H, D) q, k, v: the forward through B1 with its
    logsumexp and the fp32 merge, the backward through B4/B5 with each
    query block's merged lse and delta, dK/dV summed per K/V block in fp32.
    Equal to :func:`ring_attention_sharded` over n ranks."""
    if q.shape[1] % n:
        raise ValueError(f"ring attention: token axis {q.shape[1]} not divisible by the ring's size {n}")
    return _VirtualRing.apply(q, k, v, n)
