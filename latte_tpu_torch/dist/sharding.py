"""Where each parameter, Adam moment and EMA entry lives over the
(dp, ep, sp, tp, pp) mesh, and the training step's collectives (port of
``latte_tpu/dist/sharding.py``).

The rules, over the port's parameter names:

- **tp** (``tensor_parallel > 1``, Megatron, the JAX ``_spec_for``): inside
  ``blocks`` the column-parallel layers (``qkv``, ``fc1``, ``to_q/k/v``,
  ``net.0.proj``) split their output axis and their bias over ``tp``, the
  row-parallel ones (``proj``, ``fc2``, ``to_out``, ``net.2``) their input
  axis (weights only; their bias is whole and added once). Everything outside
  ``blocks``, the adaLN modulations and the MoE experts are replicated. The
  int8 serving buffers follow their weight (``weight_i8`` as ``weight``, a
  column layer's per-channel ``weight_scale`` as its rows, the per-head
  ``q/k/v_scale`` by heads); per-tensor ``act_scale`` is whole. The JAX qkv
  output is head-major, (H, 3, hd), so its contiguous split lands on whole
  heads; the port's qkv rows keep the reference's [q|k|v] order, so a tp
  rank's rows are ``view(3, H, hd, C)[:, h0:h1]``: the same heads of q, k
  and v (:func:`tp_shard`, :func:`tp_unshard`).
- **ep** (``expert_parallel > 1``): the expert axis (0) of the MoE weights
  ``*.moe.wi``/``bi``/``wo``/``bo`` goes over ``ep``; each rank holds its
  E/ep experts (``models/moe.py`` builds them so). Routers and every other
  weight are replicated. Their moments and EMA mirror them.
- **fsdp**: every block parameter (``blocks.*``) goes over ``dp`` on its
  largest dp-divisible axis, through FSDP2's ``fully_shard`` (per block, then
  the model, whose embedders and final layer stay replicated); a block
  parameter with no such axis stays replicated. The axes the JAX rule
  composes on top of its Megatron ``tp`` rule are not candidates, as there,
  even at tp = 1: the output axis of a column-parallel linear (``qkv``,
  ``fc1``; so their biases stay whole), the input axis of a row-parallel one
  (``proj``, ``fc2``), and an expert weight's expert axis under ep. The EMA
  copy is sharded alike, and the moments follow their shards.
- **zero1**: each moment goes over ``dp`` on its (tp-local) parameter's
  largest dp-divisible axis; parameters and EMA stay replicated. With ``ep``
  it raises the JAX trainer's ``ValueError``. Under tp the port's moments
  are those of the rank's tp shard, split over dp; the JAX trainer's
  ``zero1_opt_shardings`` splits the whole moment over dp alone and
  replicates it over tp (more bytes a device, the same values).

- **pp** (``pipeline_parallel > 1``, ``pp_param_shardings``): a block entry
  (``blocks.{i}``, ``transformer_blocks.{i}``,
  ``temporal_transformer_blocks.{i}``) lives on the stage that holds pair
  ``i`` alone (the model is built so, ``dist.pipeline.StageBlocks``); its
  gradient is averaged over dp, and its squares sum over pp in the norm.
  Every other entry (the embedders, the final layer) is replicated over pp:
  each stage holds its share of its gradient (stage 0 the patch
  embedding's, each stage the conditioning's of its own pairs, the last the
  final layer's, ``dist.pipeline.last_stage_grad``), which is summed over
  pp (and averaged over dp), so every stage holds the one-process gradient;
  it counts once in the norm. ``zero1`` splits each stage-local moment over
  dp as above; ``fsdp`` with pp is the JAX trainer's ``ValueError``.

The axis a split takes is the port's choice (JAX's layout stacks the blocks
and transposes the linears); the bytes a rank holds are the JAX rule's
(:func:`local_numels`).

:class:`ShardedParams` carries a step's collectives: gradient averaging over
the ranks that hold the same entry and see other data or hold the same
copy (a dense gradient over dp·ep·sp, and over tp when the parameter is not
tp-split, so no replica can drift; an expert's over dp·sp·tp; after FSDP's
reduce-scatter over dp, the rest of those axes), the norm of the full
gradient (each local part's squares summed over the axes that split it:
dp under FSDP, ep for an expert, tp for a tp shard), the ZeRO-1 update of a
rank's slice and the gather of the parameters after it, the EMA of the local
shards, and the full state of the one-process checkpoint format, gathered to
rank 0 (over dp, ep and tp, then each stage's blocks over pp, in the
one-process order) and cut again on load.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

__all__ = [
    "EXPERT_KEYS", "ZERO1_EP_ERROR", "PIPELINE_BLOCKS", "is_expert", "is_block", "stage_block", "pp_order",
    "largest_axis", "fsdp_axis", "local_numels",
    "tp_axis", "tp_shard", "tp_unshard", "tp_shard_state_dict", "apply_fsdp", "ShardedParams",
]

EXPERT_KEYS = ("wi", "bi", "wo", "bo")
ZERO1_EP_ERROR = (
    "zero1 + expert_parallel: use fsdp instead (its rule composes the ep and dp splits without "
    "moment resharding)"
)


def is_expert(name: str) -> bool:
    """An MoE expert weight: its axis 0 is the expert axis."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in EXPERT_KEYS


def is_block(name: str) -> bool:
    return name.startswith("blocks.")


# the block lists a pipeline stage splits: Latte's, LatteT2V's two
PIPELINE_BLOCKS = ("blocks", "transformer_blocks", "temporal_transformer_blocks")


def stage_block(name: str) -> Optional[Tuple[str, int, str]]:
    """``(list, index, rest)`` of an entry of a pipeline block list, else
    None."""
    parts = name.split(".", 2)
    if len(parts) == 3 and parts[0] in PIPELINE_BLOCKS and parts[1].isdigit():
        return parts[0], int(parts[1]), parts[2]
    return None


def stage_spans(names: Iterable[str]) -> Dict[str, Tuple[int, int]]:
    """(first index, count) of each block list among a stage's entries."""
    held: Dict[str, set] = {}
    for name in names:
        sb = stage_block(name)
        if sb is not None:
            held.setdefault(sb[0], set()).add(sb[1])
    return {c: (min(ix), len(ix)) for c, ix in held.items()}


def pp_order(names: List[str], spans: Dict[str, Tuple[int, int]], pp: int) -> List[Tuple[str, Optional[int], str]]:
    """The one-process entries of a stage's ``names`` (in its state-dict
    order) over ``pp`` stages that hold ``spans`` blocks each: ``(one-process
    name, stage or None for a replicated entry, this stage's like entry)`` in
    the one-process order (each run of a block list's entries repeated for
    every stage, its indices shifted)."""
    out, i = [], 0
    while i < len(names):
        sb = stage_block(names[i])
        if sb is None:
            out.append((names[i], None, names[i]))
            i += 1
            continue
        j = i
        while j < len(names) and (stage_block(names[j]) or ("",))[0] == sb[0]:
            j += 1
        first, count = spans[sb[0]]
        for s in range(pp):
            for name in names[i:j]:
                c, idx, rest = stage_block(name)
                out.append((f"{c}.{idx - first + s * count}.{rest}", s, name))
        i = j
    return out


def largest_axis(shape, n: int, skip: Iterable[int] = ()) -> Optional[int]:
    """The JAX rules' choice: the largest axis divisible by ``n`` (the first
    of equal ones), not in ``skip``; None when none is, or it is below n."""
    best, best_size = None, 0
    for axis, size in enumerate(shape):
        if axis not in skip and size % n == 0 and size > best_size:
            best, best_size = axis, size
    return best if best is not None and best_size >= n else None


# the JAX rule's Megatron layers: column-parallel (output axis over tp) and
# row-parallel (input axis over tp); LatteT2V's feed-forward layers are
# ``net.0.proj`` and ``net.2`` in the port's names
_COLUMN_KEYS = ("qkv", "fc1", "to_q", "to_k", "to_v", "net_0_proj")
_ROW_KEYS = ("proj", "fc2", "to_out", "net_2")
# the tensors of a layer that its split cuts (the int8 serving buffers too)
_COLUMN_LEAVES = ("weight", "bias", "weight_i8", "weight_scale")
_ROW_LEAVES = ("weight", "weight_i8")
_HEAD_SCALES = ("q_scale", "k_scale", "v_scale")


def _tp_layer(name: str) -> Optional[str]:
    """"column", "row" or None: the Megatron role of the layer holding
    ``name``, by the last of its path's layer keys."""
    path = name.replace("net.0.proj.", "net_0_proj.").replace("net.2.", "net_2.")
    layer = [p for p in path.split(".") if p in _COLUMN_KEYS + _ROW_KEYS]
    if not layer:
        return None
    return "column" if layer[-1] in _COLUMN_KEYS else "row"


def tp_axis(name: str, ndim: int) -> Optional[int]:
    """The axis of a block tensor (a linear's weight is (out, in)) that the
    JAX rule gives to ``tp``, or None (replicated)."""
    if not is_block(name):
        return None
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _HEAD_SCALES:
        return 0
    kind = _tp_layer(name)
    if kind == "column" and leaf in _COLUMN_LEAVES:
        return 0
    if kind == "row" and leaf in _ROW_LEAVES and ndim >= 2:
        return 1
    return None


def _is_qkv(name: str) -> bool:
    return name.rsplit(".", 2)[-2:-1] == ["qkv"]


def tp_shard(name: str, t: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s part of the whole tensor ``t`` under ``tp`` shards
    (``t`` itself when the rule replicates it; a view where it can be). The
    fused qkv rows are [q|k|v]: each rank takes its heads of all three."""
    axis = tp_axis(name, t.dim())
    if axis is None or tp == 1:
        return t
    if t.shape[axis] % tp:
        raise ValueError(f"tensor_parallel={tp} does not divide axis {axis} of {name} {tuple(t.shape)}")
    if _is_qkv(name):
        return t.view(3, tp, t.shape[0] // (3 * tp), *t.shape[1:])[:, rank].reshape(-1, *t.shape[1:])
    n = t.shape[axis] // tp
    return t.narrow(axis, rank * n, n)


def tp_unshard(name: str, parts: List[torch.Tensor]) -> torch.Tensor:
    """The whole tensor from every rank's part (in rank order), the inverse
    of :func:`tp_shard`."""
    axis = tp_axis(name, parts[0].dim())
    if axis is None or len(parts) == 1:
        return parts[0]
    if _is_qkv(name):
        rest = parts[0].shape[1:]
        return torch.stack([p.reshape(3, -1, *rest) for p in parts], dim=1).reshape(-1, *rest)
    return torch.cat(parts, dim=axis)


def tp_shard_state_dict(sd: Dict[str, torch.Tensor], tp: int, rank: int) -> Dict[str, torch.Tensor]:
    """A one-process state dict cut to tp rank ``rank``'s (contiguous
    copies)."""
    return {k: tp_shard(k, v, tp, rank).contiguous() for k, v in sd.items()}


def _tp_axes(name: str, ndim: int) -> Tuple[int, ...]:
    """The axes of a port parameter that the JAX rule gives to ``tp``."""
    axis = tp_axis(name, ndim)
    return () if axis is None else (axis,)


def fsdp_axis(name: str, shape, dp: int, ep: int) -> Optional[int]:
    """The axis of a block parameter that FSDP splits over dp (None:
    replicated, as every non-block parameter is)."""
    if not is_block(name):
        return None
    skip = _tp_axes(name, len(shape)) + ((0,) if ep > 1 and is_expert(name) else ())
    return largest_axis(shape, dp, skip=skip)


def local_numels(named_shapes, dp: int, ep: int, fsdp: bool = False, zero1: bool = False,
                 tp: int = 1) -> Tuple[int, int]:
    """(parameter elements, moment elements per moment) one rank holds, from
    the full shapes of the one-process model, by the rules above."""
    params = moments = 0
    for name, shape in named_shapes:
        local = list(shape)
        if ep > 1 and is_expert(name):
            local[0] //= ep
        axis = tp_axis(name, len(shape)) if tp > 1 else None
        if axis is not None:
            local[axis] //= tp
        n = 1
        for s in local:
            n *= s
        p = n
        if fsdp and fsdp_axis(name, local, dp, ep) is not None:
            p = n // dp
        m = p
        if zero1 and largest_axis(local, dp) is not None:
            m = n // dp
        params += p
        moments += m
    return params, moments


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (an alias of its storage); a tensor as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t._local_tensor
    return t


def apply_fsdp(model: nn.Module, ctx) -> nn.Module:
    """FSDP2 ``fully_shard`` over ``dp``: each block by :func:`fsdp_axis`
    (``Shard(axis)``; a parameter with no axis is left to itself), then the
    model, whose own parameters (embedders, final layer) it leaves
    replicated."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    mesh = ctx.mesh["dp"]
    for i, block in enumerate(model.blocks):
        placements, ignored = {}, set()
        for pname, p in block.named_parameters():
            axis = fsdp_axis(f"blocks.{i}.{pname}", p.shape, ctx.dp, ctx.ep)
            if axis is None:
                ignored.add(p)
            else:
                placements[p] = Shard(axis)
        fully_shard(block, mesh=mesh, reshard_after_forward=True,
                    shard_placement_fn=placements.get, ignored_params=ignored or None)
    own = {p for name, p in model.named_parameters() if not is_block(name)}
    fully_shard(model, mesh=mesh, reshard_after_forward=True, ignored_params=own or None)
    return model


class _Entry:
    """A trainable parameter: its name, the tensor the model holds, the
    leaf the optimizer updates (the parameter, its DTensor shard, or its
    ZeRO-1 slice, each an alias of the parameter's storage), and how its
    gradient reduces."""

    def __init__(self, name: str, param: torch.Tensor, ctx, zero1: bool):
        from torch.distributed.tensor import DTensor

        self.name, self.param = name, param
        self.fsdp = isinstance(param, DTensor)
        self.expert = ctx.ep > 1 and is_expert(name)
        self.tp_split = ctx.tp > 1 and tp_axis(name, param.dim()) is not None
        self.axis = largest_axis(param.shape, ctx.dp) if zero1 and ctx.dp > 1 else None
        with torch.no_grad():
            local = _local(param)
            if self.axis is not None:
                n = param.shape[self.axis] // ctx.dp
                self.leaf = nn.Parameter(local.narrow(self.axis, ctx.dp_rank * n, n))
            elif self.fsdp:
                self.leaf = nn.Parameter(local)
            else:
                self.leaf = param
        # a pipeline stage's own block entry, or one replicated over pp
        self.stage_local = ctx.pp > 1 and stage_block(name) is not None
        # the axes whose ranks hold this entry and average its gradient: those
        # that see other rows (dp, sp), and those that hold the same copy
        # (ep for a dense entry, tp for one tp does not split); FSDP's
        # reduce-scatter has averaged over dp already
        axes = ("dp", "sp") + (() if self.expert else ("ep",)) + (() if self.tp_split else ("tp",))
        if self.fsdp:
            axes = tuple(a for a in axes if a != "dp")
        self.n = ctx.size(*axes)
        # a replicated entry's stage shares are summed over pp (not averaged)
        summed = ("pp",) if ctx.pp > 1 and not self.stage_local else ()
        self.group = ctx.group(*axes, *summed)
        # the group the squares of a gradient's local part sum over for the
        # norm: the axes that split it
        split = ((("dp",) if self.fsdp else ()) + (("ep",) if self.expert else ()) + (("tp",) if self.tp_split else ())
                 + (("pp",) if self.stage_local else ()))
        self.norm_group = ctx.group(*split)


class ShardedParams:
    """The trainable parameters of ``model`` on this rank of ``ctx`` and the
    step's collectives (see the module docstring). ``leaves`` are what the
    optimizer updates, in ``model.parameters()`` order, so its state dict
    indexes them as the one-process optimizer does."""

    def __init__(self, model: nn.Module, ctx, zero1: bool = False):
        if zero1 and ctx.ep > 1:
            raise ValueError(ZERO1_EP_ERROR)
        self.ctx = ctx
        self.entries = [_Entry(n, p, ctx, zero1) for n, p in model.named_parameters() if p.requires_grad]
        # the blocks of each list a pipeline stage holds
        self.spans = stage_spans(model.state_dict()) if ctx.pp > 1 else {}
        # a norm that sums over no group is the one-process norm, to the bit
        self.plain_norm = all(e.norm_group is None for e in self.entries)

    @property
    def leaves(self) -> List[torch.Tensor]:
        return [e.leaf for e in self.entries]

    def reduce_grads(self, chunks: int = 1) -> List[torch.Tensor]:
        """Average every gradient over the ranks that share its parameter
        (and over ``chunks`` accumulated backwards), and hand each leaf its
        part; returns the local gradients (for :meth:`grad_norm`)."""
        works, todo = [], []
        for e in self.entries:
            if e.param.grad is None:
                e.param.grad = torch.zeros_like(e.param)
            g = _local(e.param.grad)
            if e.group is not None:
                works.append(dist.all_reduce(g, group=e.group, async_op=True))
            todo.append((e, g, e.n * chunks))
        for w in works:
            w.wait()
        for e, g, n in todo:
            if n != 1:
                g.div_(n)
            e.leaf.grad = g if e.axis is None else g.narrow(e.axis, self.ctx.dp_rank * e.leaf.shape[e.axis],
                                                          e.leaf.shape[e.axis])
        return [g for _, g, _ in todo]

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The norm of the full gradient from :meth:`reduce_grads`' local
        gradients: each local part's squares summed over the ranks that
        split it."""
        from latte_tpu_torch.train.step import global_norm

        if self.plain_norm:
            return global_norm(grads)
        cpu = grads[0].device.type == "cpu"
        norms = [torch.linalg.vector_norm(g, dtype=torch.float64 if cpu else None) for g in grads]
        by_group: Dict[object, list] = {}
        for e, n in zip(self.entries, norms):
            by_group.setdefault(e.norm_group, []).append(n)
        total = None
        for group, ns in by_group.items():
            sq = torch.stack(ns).square().sum()
            if group is not None:
                dist.all_reduce(sq, group=group)
            total = sq if total is None else total + sq
        return total.sqrt().float()

    @torch.no_grad()
    def gather_params(self) -> None:
        """After a ZeRO-1 update: every rank's slice back into the whole
        parameter."""
        for e in self.entries:
            if e.axis is not None:
                parts = [torch.empty_like(e.leaf) for _ in range(self.ctx.dp)]
                dist.all_gather(parts, e.leaf.contiguous(), group=self.ctx.dp_group)
                e.param.copy_(torch.cat(parts, dim=e.axis))

    @staticmethod
    @torch.no_grad()
    def update_ema(ema: nn.Module, model: nn.Module, decay: float) -> None:
        """``ema ← decay·ema + (1 − decay)·params`` on the local shards (the
        EMA is sharded as the model is)."""
        torch._foreach_lerp_([_local(p) for p in ema.parameters()], [_local(p) for p in model.parameters()],
                             1.0 - decay)

    # -- the one-process checkpoint format -------------------------------

    def _full(self, name: str, t: torch.Tensor, like: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's part: ``like`` is
        the parameter (a DTensor gives the dp placement), ``axis`` a ZeRO-1
        slice's."""
        from torch.distributed.tensor import DTensor

        ctx = self.ctx
        if isinstance(t, DTensor):
            t = t.full_tensor()
        elif isinstance(like, DTensor):
            t = DTensor.from_local(t, like.device_mesh, like.placements, shape=like.shape,
                                   stride=like.stride()).full_tensor()
        if axis is not None:
            parts = [torch.empty_like(t) for _ in range(ctx.dp)]
            dist.all_gather(parts, t.contiguous(), group=ctx.dp_group)
            t = torch.cat(parts, dim=axis)
        if ctx.ep > 1 and is_expert(name):
            parts = [torch.empty_like(t) for _ in range(ctx.ep)]
            dist.all_gather(parts, t.contiguous(), group=ctx.ep_group)
            t = torch.cat(parts)
        if ctx.tp > 1 and tp_axis(name, t.dim()) is not None:
            parts = [torch.empty_like(t) for _ in range(ctx.tp)]
            dist.all_gather(parts, t.contiguous(), group=ctx.tp_group)
            t = tp_unshard(name, parts)
        # rank 0 of each pipeline stage (ranks 0..pp-1, pp innermost)
        return t.detach().cpu() if ctx.rank < ctx.pp else None

    def _gather_stages(self, local: Dict[str, Optional[torch.Tensor]]) -> Optional[Dict[str, torch.Tensor]]:
        """The one-process dict on rank 0 from each stage's rank 0's
        ``local`` entries (a collective; None elsewhere): the replicated
        entries are rank 0's, each stage's blocks are sent to it, in the
        one-process order."""
        ctx = self.ctx
        if ctx.pp == 1:
            return local if ctx.rank == 0 else None
        order = pp_order(list(local), self.spans, ctx.pp)
        if ctx.rank == 0:
            out = {}
            for name, stage, mine in order:
                if not stage:
                    out[name] = local[mine]
                    continue
                buf = torch.empty_like(local[mine], device=ctx.device)
                dist.recv(buf, src=ctx.stage_rank(stage))
                out[name] = buf.cpu()
            return out
        if ctx.rank < ctx.pp:
            for name, stage, mine in order:
                if stage == ctx.pp_rank:
                    dist.send(local[mine].to(ctx.device), dst=0)
        return None

    def _part(self, name: str, full: torch.Tensor, like: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        """This rank's part of a whole tensor, the inverse of :meth:`_full`."""
        from torch.distributed.tensor import DTensor

        ctx = self.ctx
        full = tp_shard(name, full, ctx.tp, ctx.tp_rank)
        if ctx.ep > 1 and is_expert(name):
            full = full.chunk(ctx.ep)[ctx.ep_rank]
        if isinstance(like, DTensor):
            dim = like.placements[0].dim
            chunks = full.chunk(ctx.dp, dim)
            full = chunks[ctx.dp_rank] if ctx.dp_rank < len(chunks) else full.narrow(dim, 0, 0)
        if axis is not None:
            n = full.shape[axis] // ctx.dp
            full = full.narrow(axis, ctx.dp_rank * n, n)
        return full

    def full_state_dict(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        """``module``'s state dict with every tensor whole, on the CPU of
        rank 0 (None elsewhere; a collective: every rank calls it)."""
        params = dict(module.named_parameters())
        return self._gather_stages({name: self._full(name, t, params.get(name, t))
                                    for name, t in module.state_dict().items()})

    @torch.no_grad()
    def load_full_state_dict(self, module: nn.Module, full: Dict[str, torch.Tensor]) -> None:
        """Each parameter takes its part of a whole state dict (strict)."""
        params = dict(module.named_parameters())
        names = list(module.state_dict())
        want = [n for n, _, _ in pp_order(names, self.spans, self.ctx.pp)] if self.ctx.pp > 1 else names
        missing = set(want) ^ set(full)
        if missing:
            raise KeyError(f"state dict keys differ: {sorted(missing)[:8]}")
        for name, p in params.items():
            _local(p).copy_(self._part(name, full[name].to(p.device), p))

    def full_optimizer_state(self, optimizer: torch.optim.Optimizer) -> dict:
        """The optimizer's state dict in the one-process layout, every
        moment whole (on rank 0, as :meth:`full_state_dict`)."""
        sd = optimizer.state_dict()
        if self.ctx.pp > 1:
            return self._full_pp_optimizer_state(sd)
        for i, e in enumerate(self.entries):
            st = sd["state"].get(i)
            if st is None:
                continue
            st = dict(st)
            for key in ("exp_avg", "exp_avg_sq"):
                st[key] = self._full(e.name, st[key], e.param, e.axis)
            sd["state"][i] = st
        return sd

    def _one_process_index(self) -> Dict[str, int]:
        """Each trainable entry's index in the one-process optimizer."""
        order = pp_order([e.name for e in self.entries], self.spans, self.ctx.pp)
        return {name: i for i, (name, _, _) in enumerate(order)}

    def _full_pp_optimizer_state(self, sd: dict) -> Optional[dict]:
        """:meth:`full_optimizer_state` over pipeline stages: every stage's
        moments gathered to rank 0 by name, indexed as the one-process
        optimizer indexes its parameters."""
        moments = {}
        for key in ("exp_avg", "exp_avg_sq"):
            moments[key] = self._gather_stages({e.name: self._full(e.name, sd["state"][i][key], e.param, e.axis)
                                                for i, e in enumerate(self.entries)})
        if self.ctx.rank != 0:
            return None
        rest = {k: v for k, v in sd["state"][0].items() if k not in moments}  # the step
        index = self._one_process_index()
        state = {index[name]: dict(rest, exp_avg=mu, exp_avg_sq=moments["exp_avg_sq"][name])
                 for name, mu in moments["exp_avg"].items()}
        groups = [dict(g, params=list(range(len(index)))) for g in sd["param_groups"]]
        return {"state": state, "param_groups": groups}

    def load_full_optimizer_state(self, optimizer: torch.optim.Optimizer, full: dict) -> None:
        sd = {"state": {}, "param_groups": full["param_groups"]}
        index = self._one_process_index() if self.ctx.pp > 1 else None
        if index is not None:
            sd["param_groups"] = [dict(g, params=list(range(len(self.entries)))) for g in full["param_groups"]]
        for i, e in enumerate(self.entries):
            st = full["state"].get(i if index is None else index[e.name])
            if st is None:
                continue
            st = dict(st)
            for key in ("exp_avg", "exp_avg_sq"):
                st[key] = self._part(e.name, st[key], e.param, e.axis).clone()
            sd["state"][i] = st
        optimizer.load_state_dict(sd)
