"""Mixture-of-Experts feed-forward (port of ``latte_tpu/models/moe.py``),
on one device or split over the ranks of a :class:`~latte_tpu_torch.dist.
mesh.DistContext` (expert parallelism, below).

The block's dense MLP becomes E expert MLPs behind a learned top-k router
(Switch / GShard). Parameters keep the JAX names and layouts: ``router``
(D, E), ``wi`` (E, D, H or 2H), ``bi`` (E, H or 2H), ``wo`` (E, H, D_out),
``bo`` (E, D_out), so :func:`latte_tpu_torch.convert.flax_to_state_dict`
carries them over unchanged.

Semantics carried from the JAX layer:

- The S = B·N tokens are taken in the order of the input's layout and cut
  into G groups of g tokens, g the largest divisor of S not above
  ``group_size``; each expert takes at most C = min(g, max(1, ceil(g·k·cf
  / E))) tokens a group.
- The router computes in fp32 in any model type (``router`` stays fp32 when
  the model is cast, as the int8 scales do), softmax over the E logits.
- Top-k by iterative masking with argmax (ties: the first index, in both
  libraries). Each gate is the raw probability of its choice; with k > 1
  the gates are renormalised over the k choices (``+ 1e-9``) before any
  token is dropped.
- Within a group every token's choice 0 queues before any choice 1; a
  (token, choice) past its expert's capacity is dropped, and a token with
  every choice dropped gets a zero output (the block's residual carries it).
- The Switch auxiliary loss ``E · Σ_e f_e · P_e`` takes f_e from choice 0
  before any drop and P_e as the mean probability over all S tokens.
- In a bf16 model the expert weights and the combine weights (the gates)
  are rounded to bf16, as the JAX layer casts its dispatch and combine
  tensors; the combine sums in fp32 and rounds once.

Where JAX builds (G, g, E, C) one-hot dispatch and combine tensors and
contracts them with einsums (MXU work on the TPU), this port indexes: each
kept (token, choice) gets a row of an expert-major (E·G·C, D) buffer
(``index_copy_``), one ``torch.bmm`` per expert product runs over the (E,
G·C, ·) buffers, and each token gathers its k output rows back
(``index_select``) and weights them. The one-hots would be 105 MB each in
fp32 a block at ``ffs_train_moe.yaml`` (S = 20 480, G = 40, C = 160); the
index form moves the same rows without them. Every shape is static, and
nothing waits on the host: a dropped choice writes to a spare row that is
cut off, and reads a real row at weight zero.

The layer returns ``(y, aux)``; its forward is :meth:`MoEMlp.route`,
:meth:`MoEMlp.dispatch`, :meth:`MoEMlp.experts` and :meth:`MoEMlp.combine`
in turn.

Over several ranks (``mesh``, the counterpart of the JAX layer's
``ep_axis``), the semantics stay those of the JAX layer on the global batch,
whose rows are split over ``dp`` (and, under sequence parallelism, the rows
of each dp share over ``sp``: "the rows" below are that (dp, sp) split,
``mesh.rows``) and replicated over ``ep`` and ``tp``:

- Each rank holds the E/ep experts ``[ep_rank·E/ep, (ep_rank+1)·E/ep)``;
  ``reset_parameters`` draws all E from the generator and keeps its own,
  so a seed gives the one-process model's weights.
- The groups and the capacity are the global batch's (g from S·rows
  tokens). A rank's tokens are one contiguous segment of the global token
  order, or two under the samplers' CFG doubling, whose global batch is
  [cond | uncond] of every rank's rows (``mesh.token_segments``). Where a
  group spans the ranks' segments, the choices are all-gathered over the
  rows to place each token in its queue; else nothing is exchanged. Each
  segment is dispatched, run through the experts and combined on its own.
- Every rank of an ep group routes the group's tokens alike, runs its own
  experts on them and all-reduces its share of the combine over ``ep``.
  That all-reduce passes the gradient through unchanged, and the inputs of
  the experts' share (the tokens and the gates) all-reduce their gradients
  over ``ep``: each rank's share of the input gradient is partial, and the
  sum is the whole, so every rank ends with the one-process gradient of
  every weight it holds.
- f_e of the Switch loss is all-reduced over the rows, P_e stays this
  rank's mean: the mean of the ranks' losses (and of their gradients, which
  the step averages) is the global batch's ``E · Σ_e f_e · P_e``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from latte_tpu_torch.models.layers import _Fp32Scales

__all__ = ["MoEMlp", "ACTIVATIONS", "moe_groups", "collect_loss", "pair_losses", "loss_columns"]

ACTIVATIONS = ("gelu-approximate", "geglu")


def moe_groups(S: int, num_experts: int, top_k: int, capacity_factor: float, group_size: int = 512):
    """(g, C): the dispatch group of S tokens (the largest divisor of S not
    above ``group_size``) and an expert's capacity a group, as the JAX layer
    computes them (Python floats and ``math.ceil``)."""
    k = min(top_k, num_experts)
    g = min(group_size, S)
    while S % g:
        g -= 1
    C = max(1, int(math.ceil(g * k * capacity_factor / num_experts)))
    return g, min(C, g)


def collect_loss(out, losses: list) -> torch.Tensor:
    """A block's output: a dense block's as it is; an MoE block's ``(x,
    loss)`` gives x, and its Switch loss goes to ``losses``."""
    if isinstance(out, tuple):
        out, loss = out
        losses.append(loss)
    return out


def pair_losses(losses: list) -> Optional[torch.Tensor]:
    """A block pair's Switch losses as one tensor (spatial block first);
    None for dense blocks."""
    return torch.stack(losses) if losses else None


def loss_columns(pair_aux: list) -> Optional[torch.Tensor]:
    """The pairs' losses -> (columns, n_pairs): row 0 the spatial blocks',
    row 1 the temporal blocks'; None for dense blocks."""
    if not pair_aux or pair_aux[0] is None:
        return None
    return torch.stack(pair_aux, dim=1)


class _SumGrad(torch.autograd.Function):
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


class _SumOut(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class MoEMlp(_Fp32Scales):
    """Drop-in MoE replacement for :class:`~latte_tpu_torch.models.layers.Mlp`
    and the T2V feed-forward: ``(B, N, D) -> ((B, N, D_out), aux)``.

    ``activation_fn``: ``"gelu-approximate"`` (tanh gelu, the Latte MLP) or
    ``"geglu"`` (``wi`` projects to 2H; the first half times the exact gelu
    of the second, the LatteT2V feed-forward). ``E == 1`` is the dense MLP.
    ``mesh`` (a ``DistContext`` with dp·ep > 1) splits it over the ranks as
    the module docstring says; ``None`` is the one-process layer.
    """

    FP32_BUFFERS = ("router",)

    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        out_features: int,
        num_experts: int,
        top_k: int = 2,
        capacity_factor: float = 1.25,
        activation_fn: str = "gelu-approximate",
        group_size: int = 512,
        mesh=None,
    ):
        super().__init__()
        if activation_fn not in ACTIVATIONS:
            raise NotImplementedError(activation_fn)
        if mesh is not None and mesh.rows * mesh.ep == 1:
            mesh = None
        ep = mesh.ep if mesh is not None else 1
        if num_experts % ep:
            raise ValueError(f"expert_parallel={ep} needs moe_experts (got {num_experts}) divisible by it")
        self.mesh = mesh
        self.local_experts = num_experts // ep
        self.first_expert = (mesh.ep_rank if mesh is not None else 0) * self.local_experts
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.activation_fn = activation_fn
        self.group_size = group_size
        E, H = self.local_experts, hidden_features
        h_in = 2 * H if activation_fn == "geglu" else H
        self.router = nn.Parameter(torch.empty(in_features, num_experts))
        self.wi = nn.Parameter(torch.empty(E, in_features, h_in))
        self.bi = nn.Parameter(torch.zeros(E, h_in))
        self.wo = nn.Parameter(torch.empty(E, H, out_features))
        self.bo = nn.Parameter(torch.zeros(E, out_features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX layer's init: router N(0, 0.02²), each expert's ``wi`` and
        ``wo`` slice xavier-uniform over its (in, out) fans, zero biases.
        Every expert is drawn, in order; a rank keeps its own."""
        nn.init.normal_(self.router, std=0.02, generator=generator)
        for w in (self.wi, self.wo):
            scratch = torch.empty_like(w[0])
            for e in range(self.num_experts):
                local = e - self.first_expert
                target = w[local] if 0 <= local < self.local_experts else scratch
                nn.init.xavier_uniform_(target, generator=generator)
        nn.init.zeros_(self.bi)
        nn.init.zeros_(self.bo)

    def route(self, xf: torch.Tensor):
        """Router of the (S, D) tokens: ``(probs, choices, gates, aux)``, the
        fp32 softmax (S, E), the k chosen experts (S,) each, their gates
        (renormalised when k > 1) and the Switch loss."""
        E = self.num_experts
        probs = (xf.float() @ self.router).softmax(dim=-1)
        p, choices, gates = probs.detach(), [], []
        for _ in range(min(self.top_k, E)):
            idx = p.argmax(dim=-1)
            choices.append(idx)
            gates.append(probs.gather(1, idx[:, None]).squeeze(1))
            p = p.scatter(1, idx[:, None], 0.0)
        if len(gates) > 1:
            denom = sum(gates) + 1e-9
            gates = [gate / denom for gate in gates]
        f = (choices[0][:, None] == torch.arange(E, device=xf.device)).float().mean(dim=0)
        if self.mesh is not None and self.mesh.rows > 1:
            # f_e of the global batch; P_e stays this rank's (see the module docstring)
            dist.all_reduce(f, group=self.mesh.row_group)
            f = f / self.mesh.rows
        return probs, choices, gates, E * (f * probs.mean(dim=0)).sum()

    def dispatch(self, xf: torch.Tensor, choices, gates, g: int, C: int, offset: int = 0, context=None):
        """Each (token, choice) to its place in its expert's queue of the
        group: ``(xin, slots, weights)``, the expert-major (E, G·C, D)
        buffer (zeros where no token sits), each choice's row in it (S,)
        (``E·G·C``, the spare row, when dropped), and its combine weight
        (the gate, 0 when dropped) in the input's type.

        Over several ranks E is this rank's experts (a choice of another
        rank's expert weighs 0 here), the xf rows are tokens ``[offset,
        offset + S)`` of the global sequence, G the groups they touch, and
        ``context`` the choices of every token of those groups (all-gathered
        over dp; None: xf's own)."""
        S, D = xf.shape
        E, e0 = self.local_experts, self.first_expert
        ctx = choices if context is None else context
        lo = offset - (offset // g) * g  # xf's first token within the context
        grp0 = offset // g
        G = (offset + S - 1) // g - grp0 + 1
        Gc = ctx[0].shape[0] // g
        rows = E * G * C
        experts = torch.arange(self.num_experts, device=xf.device)
        counts = torch.zeros((Gc, 1, self.num_experts), dtype=torch.int32, device=xf.device)
        group = (torch.arange(offset, offset + S, device=xf.device) // g - grp0).view(S)
        slots, weights = [], []
        for full, gate in zip(ctx, gates):
            m = (full[:, None] == experts).to(torch.int32).view(Gc, g, self.num_experts)
            pos = (m.cumsum(dim=1) - m + counts).gather(2, full.view(Gc, g, 1)).view(-1)[lo : lo + S]
            counts = counts + m.sum(dim=1, keepdim=True)
            idx = full.view(-1)[lo : lo + S] - e0
            keep = (pos < C) & (idx >= 0) & (idx < E)
            slot = (idx * G + group) * C + pos
            slots.append(torch.where(keep, slot, rows))
            weights.append((gate * keep).to(xf.dtype))
        xin = xf.new_zeros((rows + 1, D))
        for slot in slots:
            xin.index_copy_(0, slot, xf)
        return xin[:rows].view(E, G * C, D), slots, weights

    def experts(self, xin: torch.Tensor) -> torch.Tensor:
        """The E expert MLPs on their (E, G·C, D) rows, one batched product
        each way: (E·G·C, D_out)."""
        dtype = xin.dtype
        h = torch.baddbmm(self.bi.to(dtype)[:, None], xin, self.wi.to(dtype))
        if self.activation_fn == "geglu":
            h, gate = h.chunk(2, dim=-1)
            h = h * F.gelu(gate)
        else:
            h = F.gelu(h, approximate="tanh")
        out = torch.baddbmm(self.bo.to(dtype)[:, None], h, self.wo.to(dtype))
        return out.view(-1, out.shape[-1])

    def combine(self, out: torch.Tensor, slots, weights, dtype=None) -> torch.Tensor:
        """Each token's k output rows, weighted, summed in fp32 and rounded
        once to ``dtype`` (the output's type; None keeps fp32): (S, D_out).
        A dropped choice reads the last real row at weight 0."""
        last = out.shape[0] - 1
        y = sum(w.float()[:, None] * out.index_select(0, slot.clamp(max=last)).float()
                for slot, w in zip(slots, weights))
        return y.to(out.dtype if dtype is None else dtype)

    def forward(self, x: torch.Tensor):
        B, N, D = x.shape
        S, mesh = B * N, self.mesh
        rows, ep = (mesh.rows, mesh.ep) if mesh is not None else (1, 1)
        g, C = moe_groups(S * rows, self.num_experts, self.top_k, self.capacity_factor, self.group_size)
        segments = mesh.token_segments(S) if mesh is not None else [(0, 0, S)]
        xf = x.reshape(S, D)
        _, choices, gates, aux = self.route(xf)
        context = None
        if any(start % g or n % g for start, _, n in segments):
            # a group spans the ranks' tokens: its queues need every rank's
            # choices, placed in the global token order
            context = []
            for c in choices:
                parts = [torch.empty_like(c) for _ in range(rows)]
                dist.all_gather(parts, c.contiguous(), group=mesh.row_group)
                full = c.new_empty(S * rows)
                for q, part in enumerate(parts):
                    for start, lo, n in mesh.token_segments(S, q):
                        full[start:start + n] = part[lo:lo + n]
                context.append(full)
        if ep > 1:
            xf = _SumGrad.apply(xf, mesh.ep_group)
            gates = [_SumGrad.apply(gate, mesh.ep_group) for gate in gates]
        ys = []
        for start, lo, n in segments:
            seg_context = None
            if context is not None:
                first, last = start // g * g, ((start + n - 1) // g + 1) * g
                seg_context = [c[first:last] for c in context]
            xin, slots, weights = self.dispatch(xf[lo:lo + n], [c[lo:lo + n] for c in choices],
                                                [gate[lo:lo + n] for gate in gates], g, C, start, seg_context)
            # over ep the shares are summed in fp32 before the one rounding
            ys.append(self.combine(self.experts(xin), slots, weights, dtype=torch.float32 if ep > 1 else None))
        y = ys[0] if len(ys) == 1 else torch.cat(ys)
        if ep > 1:
            y = _SumOut.apply(y, mesh.ep_group)
        return y.to(x.dtype).view(B, N, -1), aux
