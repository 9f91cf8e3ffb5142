"""Consistency checks and model introspection (port of
``latte_tpu/diagnostics.py``): ``assert_shape``, ``check_params_consistency``
(the reference's ``check_ddp_consistency``), ``find_nonfinite``,
``print_module_summary`` (forward hooks in place of flax's ``tabulate``),
``count_params`` and ``InfiniteSampler``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["assert_shape", "check_params_consistency", "find_nonfinite", "print_module_summary",
           "count_params", "InfiniteSampler"]


def assert_shape(x, ref_shape: Sequence[Optional[int]]) -> None:
    """Assert shape; None entries are wildcards."""
    assert x.ndim == len(ref_shape), f"rank {x.ndim} != {len(ref_shape)}"
    for i, (got, want) in enumerate(zip(x.shape, ref_shape)):
        if want is not None and got != want:
            raise AssertionError(f"dim {i}: {got} != {want} (shape {tuple(x.shape)})")


def _named_tensors(obj):
    """(name, tensor) of a module's parameters and buffers, or of a dict's
    tensor values."""
    if isinstance(obj, nn.Module):
        return [*obj.named_parameters(), *obj.named_buffers()]
    return [(k, v) for k, v in obj.items() if isinstance(v, torch.Tensor)]


def check_params_consistency(module_or_state, group=None) -> bool:
    """Verify that every replicated tensor is bit-identical on every process
    of ``group`` (the default group when None): a per-tensor fp64 checksum
    (its sum and sum of squares) is gathered, and the first tensor whose
    checksums differ raises ``AssertionError`` naming it. FSDP's sharded
    tensors (``DTensor``) and a tensor-parallel module's split weights hold
    different parts on each rank and are skipped, as JAX skips the leaves
    that are not addressable. One process: nothing to compare."""
    from torch.distributed.tensor import DTensor

    from latte_tpu_torch.dist.sharding import tp_axis

    dist = torch.distributed
    tp = int(getattr(module_or_state, "tp", 1) or 1) if isinstance(module_or_state, nn.Module) else 1
    named = [(n, t) for n, t in _named_tensors(module_or_state)
             if not isinstance(t, DTensor) and not (tp > 1 and tp_axis(n, t.dim()) is not None)]
    if not named or not (dist.is_available() and dist.is_initialized()) or dist.get_world_size(group) == 1:
        return True
    device = named[0][1].device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    sums = torch.stack([torch.stack([t.detach().double().sum(), t.detach().double().square().sum()])
                        for _, t in named]).to(device)
    gathered = [torch.empty_like(sums) for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, sums, group=group)
    gathered = torch.stack(gathered).cpu()  # (world, tensors, 2)
    for i, (name, _) in enumerate(named):
        per_rank = gathered[:, i]
        if not bool((per_rank == per_rank[0]).all()):
            raise AssertionError(f"param {name} diverges across processes: checksums {per_rank.tolist()}")
    return True


def find_nonfinite(obj) -> List[str]:
    """Names of the floating-point tensors of a module (parameters and
    buffers) or a dict that hold a NaN or an Inf."""
    return [name for name, t in _named_tensors(obj)
            if t.is_floating_point() and not bool(torch.isfinite(t.detach()).all())]


def print_module_summary(module: nn.Module, *example_args, max_depth: int = 2, **example_kwargs) -> str:
    """A table of the submodules down to ``max_depth`` levels: each one's
    type, output shapes (collected by forward hooks during one forward on
    the example inputs, without grad) and parameter count; printed and
    returned."""
    rows, hooks = [], []

    def shapes(out):
        if isinstance(out, torch.Tensor):
            return [tuple(out.shape)]
        if isinstance(out, (list, tuple)):
            return [s for o in out for s in shapes(o)]
        if isinstance(out, dict):
            return [s for o in out.values() for s in shapes(o)]
        return []

    for name, sub in module.named_modules():
        depth = 0 if not name else name.count(".") + 1
        if depth > max_depth:
            continue

        def hook(mod, args, out, name=name):
            rows.append((name or "(model)", type(mod).__name__, shapes(out),
                         sum(p.numel() for p in mod.parameters())))

        hooks.append(sub.register_forward_hook(hook))
    try:
        with torch.no_grad():
            module(*example_args, **example_kwargs)
    finally:
        for h in hooks:
            h.remove()
    rows.sort(key=lambda r: (r[0] != "(model)",))
    head = ("module", "type", "outputs", "params")
    lines = [f"{head[0]:<40} {head[1]:<20} {head[2]:<36} {head[3]:>12}"]
    for name, kind, outs, n in rows:
        lines.append(f"{name:<40} {kind:<20} {', '.join(map(str, outs)):<36} {n:>12,}")
    lines.append(f"total parameters: {count_params(module):,}")
    summary = "\n".join(lines)
    print(summary)
    return summary


def count_params(module_or_state) -> int:
    """Parameters of a module (or entries of a dict of tensors)."""
    if isinstance(module_or_state, nn.Module):
        return sum(p.numel() for p in module_or_state.parameters())
    return sum(int(np.prod(v.shape)) for v in module_or_state.values())


class InfiniteSampler:
    """Infinite shard-aware shuffled index stream: a full reshuffle per
    epoch keyed on (seed, epoch), each replica taking every
    ``num_replicas``-th index from ``rank`` (JAX's, unchanged)."""

    def __init__(
        self,
        dataset_size: int,
        rank: int = 0,
        num_replicas: int = 1,
        shuffle: bool = True,
        seed: int = 0,
    ):
        assert dataset_size > 0
        assert 0 <= rank < num_replicas
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed

    def epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.dataset_size)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        return order

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            order = self.epoch_order(epoch)
            # interleaved striding: replicas partition each epoch's order
            for v in order[self.rank :: self.num_replicas]:
                yield int(v)
            epoch += 1
