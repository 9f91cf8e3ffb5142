"""Pipeline parallelism: the block pairs split by depth over ``pp`` stages
(port of ``latte_tpu/dist/pipeline.py``).

Stage ``s`` of ``S`` holds pairs ``[s·L, (s+1)·L)`` with ``L = n_pairs / S``
(:class:`StageBlocks`, built by the models from ``pp`` and ``pp_rank``;
the embedders and the final layer stay on every stage, as
``pp_param_shardings`` replicates them). Microbatches of the sample batch
stream through the stages GPipe-style (:func:`gpipe`, the counterpart of
``gpipe`` at ``:47``): ``M + S - 1`` ticks; at tick ``t`` stage ``s`` runs
microbatch ``t - s`` and hands its carry (the tokens and the conditioning
that follows a microbatch, as ``_run_pair_pipeline``'s) to stage ``s + 1``.
The last stage holds the outputs; they are broadcast over the stages, so
the result is equal on every stage, as the JAX masked ``psum`` makes it.
Idle stages compute nothing (JAX's SPMD program runs garbage ticks there).

The hop goes through a transport:

- :class:`P2PHop`: one stage a process, ``dist.batch_isend_irecv`` over
  the pp group with the peers' global ranks (NCCL on the card, gloo on the
  CPU): each tick's sends and receives in one batch.
- :class:`LocalHop`: every stage in one process, the hop a hand-over (the
  "virtual pipeline", in the spirit of ``dist.ring.virtual_ring_attention``
  and ``dist.tp.virtual_tp``): one GPU runs the schedule at full width.

The backward (JAX differentiates its scan and ``ppermute``) is one
``torch.autograd.Function`` over the schedule: its forward keeps each
stage's graph of each microbatch, every input a leaf; its backward runs the
ticks in reverse, back-propagates each stage output from the gradient the
next stage sent (the last stage: the output's) and sends its inputs'
gradients to the previous stage. The order of the point-to-point calls is
the schedule's on every rank, never the autograd engine's choice among
microbatches (with NCCL an order that differs between ranks hangs).

Every rank computes the loss on the replicated output. The final layer's
gradient is taken on the last stage alone (:func:`last_stage_grad`), so that
a non-block parameter's gradient is its stage's share on every stage and
their sum over pp is the one-process gradient (``dist.sharding``); a block's
is its stage's own.

The pipelined forwards (:func:`pipelined_latte_forward`,
:func:`pipelined_latte_img_forward`, :func:`pipelined_t2v_forward`) mirror
``:326``, ``:426`` and ``:533``: the model's embedders, the pairs through
the schedule (each under the model's remat policy: ``Latte._pair``,
LatteIMG's joint pair, LatteT2V's ``_pair``), then the final layer. The
microbatch axis is the sample batch B (temporal blocks mix frames within a
sample); the temporal position embedding is added at the model's global
pair 0 only. The models' own ``forward`` is unchanged.
:func:`make_pipelined_apply` plugs the forward into the train step
(``train.step.make_train_step(apply_fn=)``).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

__all__ = [
    "StageBlocks", "block_list", "stage_range", "init_modules", "init_named_parameters", "stage_state_dict",
    "LocalHop", "P2PHop", "make_hop", "gpipe", "last_stage_grad", "pipelined_latte_forward",
    "pipelined_latte_img_forward", "pipelined_t2v_forward", "make_pipelined_apply",
]

Carry = Tuple[Optional[torch.Tensor], ...]


# -- the stage-local model ---------------------------------------------------

def stage_range(n_units: int, stages: int, stage: int) -> range:
    """The units (pairs) of stage ``stage`` of ``stages``."""
    assert n_units % stages == 0, f"{n_units} units not divisible by pp={stages}"
    n = n_units // stages
    return range(stage * n, (stage + 1) * n)


class StageBlocks(nn.Module):
    """One stage's blocks of a block list of ``total``, under their
    one-process indices (``blocks.{i}``), so a stage's parameter names are
    the one-process model's and checkpoints need no second layout.
    ``period`` blocks make a unit (Latte's spatial/temporal pair: 2)."""

    def __init__(self, blocks: Dict[int, nn.Module], total: int, period: int = 1):
        super().__init__()
        for i, blk in blocks.items():
            self.add_module(str(i), blk)
        self.indices = sorted(blocks)
        self.total, self.period = total, period

    def __getitem__(self, i: int) -> nn.Module:
        if str(i) not in self._modules:
            raise IndexError(f"block {i} lives on another pipeline stage (this one holds "
                             f"{self.indices[0]}..{self.indices[-1]})")
        return self._modules[str(i)]

    def __contains__(self, i: int) -> bool:
        return str(i) in self._modules

    def __iter__(self) -> Iterator[nn.Module]:
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    def ghost(self, i: int) -> nn.Module:
        """A fresh copy shaped as block ``i`` (a held block of its place in
        the unit), for the initialisers' draws of an absent block."""
        first = self.indices[0]
        return copy.deepcopy(self[first + (i - first) % self.period])


def block_list(make: Callable[[int], nn.Module], total: int, period: int, pp: int = 1,
               pp_rank: int = 0) -> nn.Module:
    """The model's block list: all ``total`` blocks (``nn.ModuleList``), or
    under ``pp > 1`` a :class:`StageBlocks` of stage ``pp_rank``'s units of
    ``period`` blocks; ``make(i)`` builds block ``i``."""
    if pp == 1:
        return nn.ModuleList(make(i) for i in range(total))
    units = stage_range(total // period, pp, pp_rank)
    return StageBlocks({i: make(i) for u in units for i in range(u * period, (u + 1) * period)}, total, period)


def _expand(module: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """``module``'s children, a StageBlocks' absent blocks in their places
    as ghosts (each built when reached)."""
    for name, child in module.named_children():
        if isinstance(child, StageBlocks):
            for i in range(child.total):
                yield f"{name}.{i}", (child[i] if i in child else child.ghost(i))
        else:
            yield name, child


def init_modules(module: nn.Module) -> Iterator[nn.Module]:
    """``module.modules()`` in its order, with every absent block of a
    :class:`StageBlocks` in its place: an initialiser that draws from a
    generator in this order draws, for the blocks it holds, what the whole
    model's initialiser draws for them."""
    yield module
    for _, child in _expand(module):
        yield from init_modules(child)


def init_named_parameters(module: nn.Module, prefix: str = "") -> Iterator[Tuple[str, nn.Parameter]]:
    """``module.named_parameters()`` likewise, absent blocks in their places."""
    for name, p in module.named_parameters(recurse=False):
        yield prefix + name, p
    for name, child in _expand(module):
        yield from init_named_parameters(child, f"{prefix}{name}.")


def stage_state_dict(sd: Dict[str, torch.Tensor], model: nn.Module) -> Dict[str, torch.Tensor]:
    """A one-process state dict cut to the entries ``model`` (a stage-local
    model, or a whole one) holds; every entry it holds must be there."""
    keys = model.state_dict().keys()
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"the state dict lacks {len(missing)} of the model's entries, e.g. {missing[:4]}")
    return {k: sd[k] for k in keys}


# -- the hop ------------------------------------------------------------------

class LocalHop:
    """Every stage in this process; a hop hands the tensors over."""

    def __init__(self, stages: int):
        self.S = stages
        self.stages = list(range(stages))
        self.holds_last = True

    def exchange(self, sends: Dict[int, List[torch.Tensor]], recvs: Dict[int, List[torch.Tensor]],
                 step: int) -> Dict[int, List[torch.Tensor]]:
        """``sends[s]`` goes to stage ``s + step``; returns what each stage
        of ``recvs`` receives (``recvs[r]``: templates of it)."""
        return {r: sends[r - step] for r in recvs}

    def replicate(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        return tensors


class P2PHop:
    """This process is stage ``ctx.pp_rank`` of a :class:`~latte_tpu_torch.
    dist.mesh.DistContext` with a pp axis; a hop is one
    ``batch_isend_irecv`` with the neighbouring stages' global ranks."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.S = ctx.pp
        self.stages = [ctx.pp_rank]
        self.holds_last = ctx.pp_rank == ctx.pp - 1
        self.group = ctx.pp_group
        # the group's communicator before the first batch of point-to-point
        # calls, which involves two of its ranks only
        dist.all_reduce(torch.zeros(1, device=ctx.device), group=self.group)

    def exchange(self, sends, recvs, step: int):
        # forward hops go to the next stage and come from the previous one; backward hops the other way
        to, source = (self.ctx.pp_next, self.ctx.pp_prev) if step > 0 else (self.ctx.pp_prev, self.ctx.pp_next)
        ops, got = [], {}
        for tensors in sends.values():
            ops += [dist.P2POp(dist.isend, t.contiguous(), to, self.group) for t in tensors]
        for r, like in recvs.items():
            got[r] = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in like]
            ops += [dist.P2POp(dist.irecv, t, source, self.group) for t in got[r]]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return got

    def replicate(self, tensors):
        """The last stage's tensors on every stage (a broadcast over pp)."""
        out = [t.contiguous() if self.holds_last else torch.empty_like(t, memory_format=torch.contiguous_format)
               for t in tensors]
        for t in out:
            dist.broadcast(t, self.ctx.stage_rank(self.S - 1), group=self.group)
        return out


def make_hop(mesh) -> object:
    """The transport of ``mesh``: an int is a virtual pipeline of that many
    stages (:class:`LocalHop`), a ``DistContext`` its pp group's
    (:class:`P2PHop`)."""
    if isinstance(mesh, int):
        return LocalHop(mesh)
    if isinstance(mesh, (LocalHop, P2PHop)):
        return mesh
    return P2PHop(mesh)


# -- the schedule ---------------------------------------------------------------

def _tensors(carry: Carry) -> List[torch.Tensor]:
    return [a for a in carry if a is not None]


def _rebuild(like: Carry, tensors: List[torch.Tensor]) -> Carry:
    it = iter(tensors)
    return tuple(None if a is None else next(it) for a in like)


class _Schedule:
    """The GPipe ticks over this process's stages (``hop.stages``)."""

    def __init__(self, stage_fn, units: Sequence, hop, microbatches: Sequence[Carry]):
        self.stage_fn, self.hop, self.mbs = stage_fn, hop, list(microbatches)
        self.S, self.M = hop.S, len(self.mbs)
        L = len(units) // self.S
        assert L * self.S == len(units), f"{len(units)} units not divisible by pp={self.S}"
        self.units = [list(units[s * L:(s + 1) * L]) for s in range(self.S)]
        self.L = L
        self.saved: Dict[Tuple[int, int], Tuple[Carry, Carry]] = {}

    def _valid(self, m: int) -> bool:
        return 0 <= m < self.M

    def forward(self, record: bool) -> List[Carry]:
        """The last stage's output carry of each microbatch (None on a
        process without the last stage). ``record`` keeps each stage's
        graph for :meth:`backward`."""
        S, hop = self.S, self.hop
        outs: List[Optional[Carry]] = [None] * self.M
        arrived: Dict[int, Carry] = {}
        for t in range(self.M + S - 1):
            sends = {}
            for s in hop.stages:
                m = t - s
                if not self._valid(m):
                    continue
                x = self.mbs[m] if s == 0 else arrived.pop(s)
                if record:
                    # each stage's graph of its own, from leaves
                    x = tuple(None if a is None else
                              a.detach().requires_grad_(a.is_floating_point()) for a in x)
                    with torch.enable_grad():
                        y = self.stage_fn(self.units[s], x, s * self.L)
                    self.saved[(s, m)] = (x, y)
                else:
                    y = self.stage_fn(self.units[s], x, s * self.L)
                if s == S - 1:
                    outs[m] = y
                else:
                    sends[s] = [a.detach() for a in _tensors(y)]
            # stage r receives at the end of tick t the microbatch it runs at t + 1
            recvs = {r: _tensors(self.mbs[t + 1 - r]) for r in hop.stages if r > 0 and self._valid(t + 1 - r)}
            got = hop.exchange(sends, recvs, 1)
            arrived = {r: _rebuild(self.mbs[t + 1 - r], ts) for r, ts in got.items()}
        return outs

    def backward(self, out_grads: List[Carry]) -> List[Optional[Carry]]:
        """The ticks in reverse: each stage back-propagates its outputs from
        the gradient the next stage sent (the last stage: ``out_grads``),
        and sends its inputs' gradients to the previous one. Returns stage
        0's input gradients of each microbatch (None without stage 0)."""
        S, hop = self.S, self.hop
        in_grads: List[Optional[Carry]] = [None] * self.M
        arrived: Dict[int, List[torch.Tensor]] = {}
        for t in reversed(range(self.M + S - 1)):
            sends = {}
            for s in hop.stages:
                m = t - s
                if not self._valid(m):
                    continue
                x, y = self.saved.pop((s, m))
                g = out_grads[m] if s == S - 1 else _rebuild(y, arrived.pop(s))
                pairs = [(a, b) for a, b in zip(y, g) if a is not None and b is not None and a.requires_grad]
                if pairs:
                    torch.autograd.backward([a for a, _ in pairs], [b for _, b in pairs])
                gx = tuple(None if a is None else (a.grad if a.grad is not None else torch.zeros_like(a))
                           for a in x)
                if s == 0:
                    in_grads[m] = gx
                else:
                    sends[s] = _tensors(gx)
            # stage r receives at the end of reverse tick t the gradient it uses at t - 1
            recvs = {r: _tensors(self.mbs[t - 1 - r]) for r in hop.stages if r < S - 1 and self._valid(t - 1 - r)}
            arrived = hop.exchange(sends, recvs, -1)
        return in_grads


def _split(carry: Carry, M: int) -> List[Carry]:
    for a in _tensors(carry):
        assert a.shape[0] % M == 0, f"batch {a.shape[0]} not divisible by microbatches {M}"
    parts = [None if a is None else a.chunk(M) for a in carry]
    return [tuple(None if p is None else p[m] for p in parts) for m in range(M)]


def _join(mbs: List[Carry]) -> List[torch.Tensor]:
    return [torch.cat(list(col)) for col in zip(*[_tensors(c) for c in mbs])]


class _GPipe(torch.autograd.Function):
    """The schedule as one autograd node: outputs the joined, replicated
    output carry; its backward runs the reverse schedule. ``anchor`` (an
    empty leaf that requires grad) ties the node into the graph when no
    input requires grad (the stages' own parameters do)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, like: Carry, anchor: torch.Tensor, *inputs):
        outs = sched.forward(record=True)
        ctx.sched, ctx.like = sched, like
        joined = [t.detach() for t in _join(outs)] if sched.hop.holds_last else list(inputs)
        return tuple(sched.hop.replicate(joined))

    @staticmethod
    def backward(ctx, *grads):
        sched, like = ctx.sched, ctx.like
        ctx.sched = ctx.like = None
        out_grads = _split(_rebuild(like, list(grads)), sched.M) if sched.hop.holds_last else [None] * sched.M
        in_grads = sched.backward(out_grads)
        if in_grads[0] is None:  # stage 0 is elsewhere: the inputs' gradients are its
            return (None, None, None, *[None] * len(grads))
        need = ctx.needs_input_grad[3:]
        return (None, None, None, *[g if n else None for g, n in zip(_join(in_grads), need)])


def gpipe(stage_fn: Callable[[list, Carry, int], Carry], units: Sequence, carry: Carry, microbatches: int,
          hop) -> Carry:
    """Run ``stage_fn(stage_units, carry_mb, unit_offset) -> carry_mb`` over
    the pipeline stages of ``hop`` with ``carry`` cut into ``microbatches``
    on its leading axis (every entry's a multiple of it; ``None`` entries
    pass through; a stage keeps the shapes). ``units`` are all ``n_units``
    units (stage ``s`` gets ``units[s·L:(s+1)·L]``, ``unit_offset = s·L``).
    Returns the output carry, equal on every stage; with grad enabled, its
    backward is the reverse schedule, which leaves the stages' parameter
    gradients in their ``.grad`` (as ``backward()`` does; ``torch.autograd.
    grad`` sees the inputs' alone)."""
    hop = make_hop(hop)
    sched = _Schedule(stage_fn, units, hop, _split(carry, microbatches))
    tensors = _tensors(carry)
    if torch.is_grad_enabled():
        anchor = torch.empty(0, device=tensors[0].device, requires_grad=True)
        return _rebuild(carry, list(_GPipe.apply(sched, carry, anchor, *tensors)))
    outs = sched.forward(record=False)
    joined = _join(outs) if hop.holds_last else tensors
    return _rebuild(carry, hop.replicate(joined))


class _LastStageGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep: bool):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def last_stage_grad(x: torch.Tensor, hop) -> torch.Tensor:
    """``x`` whose gradient flows on the process of the last stage alone
    (zeros elsewhere, so the schedule's backward still runs there): what
    follows the pipeline counts once in the sum over pp."""
    if hop.holds_last or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _LastStageGrad.apply(x, False)


# -- the pipelined forwards -----------------------------------------------------

def _embed_latte(model, x, t, y, train, generator, force_drop_ids, text_embedding):
    """Latte's patch, position and conditioning embeddings (``Latte.forward``)."""
    B, F, C, H, W = x.shape
    dtype = model.compute_dtype or model.x_embedder.proj.weight.dtype
    p = model.patch_size
    tokens = model.x_embedder(x.reshape(B * F, C, H, W), dtype) + model._pos_embed(H // p, dtype)
    T = tokens.shape[1]
    t_emb = model.t_embedder(t, dtype)
    c_spatial = t_emb.repeat_interleave(F, dim=0)
    c_temp = t_emb.repeat_interleave(T, dim=0)
    if model.extras == 2:
        y_emb = model._embed_labels(y, train, force_drop_ids, generator, dtype)
        c_spatial = c_spatial + y_emb.repeat_interleave(F, dim=0)
        c_temp = c_temp + y_emb.repeat_interleave(T, dim=0)
    elif model.extras == 78:
        txt = model._embed_text(text_embedding.reshape(B, -1), dtype)
        c_spatial = c_spatial + txt.repeat_interleave(F, dim=0)
        c_temp = c_temp + txt.repeat_interleave(T, dim=0)
    # the text path conditions the final layer on the timestep alone, as the model
    c_final = c_spatial if model.extras == 2 else t_emb.repeat_interleave(F, dim=0)
    return tokens, c_spatial, c_temp, c_final, model._temp_embed(F, dtype)


def pipelined_latte_forward(model, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                            mesh, microbatches: int, train: bool = False,
                            generator: Optional[torch.Generator] = None,
                            force_drop_ids: Optional[torch.Tensor] = None,
                            text_embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Latte's forward with its pairs pipelined over ``mesh`` (a pp
    ``DistContext``, a hop, or a stage count for the virtual pipeline over a
    whole model). ``B % microbatches == 0``."""
    from latte_tpu_torch.models.layers import unpatchify

    hop = make_hop(mesh)
    B, F, C, H, W = x.shape
    M = microbatches
    assert B % M == 0, f"batch {B} not divisible by microbatches {M}"
    tokens, c_spatial, c_temp, c_final, temp_embed = _embed_latte(
        model, x, t, y, train, generator, force_drop_ids, text_embedding)

    def stage_fn(pairs, carry, offset):
        xt, cs, ct = carry
        b = xt.shape[0] // F
        for i in pairs:
            xt, _ = model._run_pair(model._pair, xt, cs, ct, temp_embed if i == 0 else None, 2 * i, b, F)
        return xt, cs, ct

    tokens = gpipe(stage_fn, range(model.depth // 2), (tokens, c_spatial, c_temp), M, hop)[0]
    out = last_stage_grad(model.final_layer(tokens, c_final), hop)
    out = unpatchify(out, model.patch_size, model.out_channels)
    return out.reshape(B, F, model.out_channels, H, W).to(x.dtype)


def pipelined_latte_img_forward(model, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
                                y_image: Optional[torch.Tensor] = None,
                                text_embedding: Optional[torch.Tensor] = None, *, mesh, microbatches: int,
                                train: bool = False, generator: Optional[torch.Generator] = None,
                                force_drop_ids: Optional[torch.Tensor] = None,
                                force_drop_ids_image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LatteIMG's forward (video frames, then ``use_image_num`` stills under
    ``train``) with its joint pairs pipelined; the labels of ``y`` then of
    ``y_image`` drawn in the model's order."""
    from latte_tpu_torch.models.layers import unpatchify

    hop = make_hop(mesh)
    B, F, C, H, W = x.shape
    M = microbatches
    assert B % M == 0, f"batch {B} not divisible by microbatches {M}"
    dtype = model.compute_dtype or model.x_embedder.proj.weight.dtype
    p = model.patch_size
    Fv = F - (model.use_image_num if train else 0)
    tokens = model.x_embedder(x.reshape(B * F, C, H, W), dtype) + model._pos_embed(H // p, dtype)
    T = tokens.shape[1]
    t_emb = model.t_embedder(t, dtype)
    c_spatial = t_emb.repeat_interleave(F, dim=0)
    c_temp = t_emb.repeat_interleave(T, dim=0)
    if model.extras == 2:
        y_emb = model._embed_labels(y, train, force_drop_ids, generator, dtype)
        if train and model.use_image_num > 0:
            y_img = model._embed_labels(y_image, train, force_drop_ids_image, generator, dtype)
            y_spatial = torch.cat([y_emb[:, None].expand(B, Fv, -1), y_img], dim=1).reshape(B * F, -1)
        else:
            y_spatial = y_emb.repeat_interleave(F, dim=0)
        c_spatial = c_spatial + y_spatial
        c_temp = c_temp + y_emb.repeat_interleave(T, dim=0)
    elif model.extras == 78:
        txt = model._embed_text(text_embedding, dtype)
        txt_spatial = torch.cat([txt[:, :1].expand(B, Fv, -1), txt[:, 1:]], dim=1)
        c_spatial = c_spatial + txt_spatial.reshape(B * F, -1)
        c_temp = c_temp + txt[:, 0].repeat_interleave(T, dim=0)
    temp_embed = model._temp_embed(Fv, dtype)

    def stage_fn(pairs, carry, offset):
        xt, cs, ct = carry
        b = xt.shape[0] // F
        for i in pairs:
            xt, _ = model._run_pair(model._joint_pair, xt, cs, ct, temp_embed if i == 0 else None, 2 * i, b, F, Fv)
        return xt, cs, ct

    tokens = gpipe(stage_fn, range(model.depth // 2), (tokens, c_spatial, c_temp), M, hop)[0]
    out = last_stage_grad(model.final_layer(tokens, c_spatial), hop)
    out = unpatchify(out, p, model.out_channels)
    return out.reshape(B, F, model.out_channels, H, W).to(x.dtype)


def pipelined_t2v_forward(model, hidden_states: torch.Tensor, timestep: torch.Tensor,
                          encoder_hidden_states: torch.Tensor,
                          encoder_attention_mask: Optional[torch.Tensor] = None, *, mesh, microbatches: int,
                          use_image_num: int = 0, train: bool = False) -> torch.Tensor:
    """LatteT2V's forward with its pairs pipelined: the per-video
    modulation, the caption context and its mask bias follow each
    microbatch from stage to stage."""
    from latte_tpu_torch.models.embeddings import get_1d_sincos_pos_embed, get_2d_sincos_pos_embed
    from latte_tpu_torch.models.t2v import MASK_BIAS

    hop = make_hop(mesh)
    B, _, F, H, W = hidden_states.shape
    M = microbatches
    assert B % M == 0, f"batch {B} not divisible by microbatches {M}"
    Fv = F - use_image_num
    p = model.patch_size
    dtype = model.proj_out.weight.dtype
    x = hidden_states.transpose(1, 2).reshape(B * F, -1, H, W)
    x = model.pos_embed(x, dtype)
    x = x + model._table(model.pos_table, get_2d_sincos_pos_embed, H // p, (H // p) ** 2, dtype)
    t_mod, emb = model.adaln_single(timestep, dtype)
    ctx = model.caption_projection(encoder_hidden_states.to(dtype))
    if use_image_num and train:
        ctx = torch.cat([ctx[:, :1].expand(-1, Fv, -1, -1), ctx[:, 1:]], dim=1)
        ctx = ctx.reshape(B * F, *ctx.shape[2:])
    else:
        ctx = ctx.repeat_interleave(F, dim=0)
    ctx_bias = None
    if encoder_attention_mask is not None:
        bias = (1.0 - encoder_attention_mask.float()) * MASK_BIAS
        if bias.dim() == 2:
            ctx_bias = bias[:, None, :].repeat_interleave(F, dim=0)
        else:
            bias = torch.cat([bias[:, :1].expand(-1, Fv, -1), bias[:, 1:]], dim=1)
            ctx_bias = bias.reshape(B * F, 1, -1)
    temp = model._table(model.temp_table, get_1d_sincos_pos_embed, Fv, Fv, dtype) if Fv > 1 else None

    def stage_fn(pairs, carry, offset):
        xt, tm, cx, cb = carry
        b = tm.shape[0]
        for i in pairs:
            xt, _ = model._run_pair(model._pair, i, xt, tm, cx, cb, temp if i == 0 else None, b, F, Fv)
        return xt, tm, cx, cb

    x = gpipe(stage_fn, range(model.num_layers), (x, t_mod, ctx, ctx_bias), M, hop)[0]
    out = model._head(x, emb, B)
    out = last_stage_grad(out, hop)
    return out.view(B, F, *out.shape[1:]).transpose(1, 2).to(hidden_states.dtype)


def make_pipelined_apply(model, mesh, microbatches: int) -> Callable:
    """The model's call signature over the pipelined forward, for
    ``make_train_step(apply_fn=...)``: LatteIMG (joint batches) or Latte by
    the model's type."""
    from latte_tpu_torch.models.dit_img import LatteIMG

    hop = make_hop(mesh)
    is_img = isinstance(model, LatteIMG)

    def apply_fn(x, t, y=None, y_image=None, *, train: bool = False, generator=None, force_drop_ids=None,
                 force_drop_ids_image=None, text_embedding=None, **kw):
        if kw:
            raise NotImplementedError(
                f"pipelined apply supports Latte/LatteIMG conditioning only (got extra kwargs {sorted(kw)})"
            )
        common = dict(mesh=hop, microbatches=microbatches, train=train, generator=generator,
                      force_drop_ids=force_drop_ids)
        if is_img:
            return pipelined_latte_img_forward(model, x, t, y, y_image, text_embedding,
                                               force_drop_ids_image=force_drop_ids_image, **common)
        return pipelined_latte_forward(model, x, t, y, text_embedding=text_embedding, **common)

    return apply_fn
