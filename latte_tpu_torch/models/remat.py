"""Gradient checkpointing of the models' spatial/temporal pairs: the
counterpart of ``nn.remat`` around the JAX models' scanned pair and of its
named policies (``latte_tpu/models/t2v.py``'s ``_remat_policy``).

"full" recomputes the whole pair in the backward; "dots"
(``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``) saves the
outputs of the products without batch dimensions, every ``Linear`` of the
pair (``aten.mm`` and ``aten.addmm``), and recomputes the rest: the glue,
the adaLN kernels and the attention, whose kernels run again in the
recompute as under "full" (selective activation checkpointing; the
hand-written kernels are not dispatcher ops, so the policy never caches
their outputs). Both are non-reentrant ``torch.utils.checkpoint``.

A pair draws no random number: the train step draws its noise, timesteps
and label dropout before the forward (``train.step.TrainStep.prologue``),
and the label embedder runs outside the pairs. So the checkpoint stashes
no RNG state (``preserve_rng_state=False``): the recompute gives the
forward's numbers without it, and nothing reads the generators' state
while the train step is captured in a CUDA graph.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

__all__ = ["REMAT_POLICIES", "check_remat_policy", "run_pair"]

REMAT_POLICIES = ("full", "dots")
# the products the "dots" policy saves: those without batch dimensions
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_dots_contexts = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def check_remat_policy(policy: str) -> None:
    """Raise the JAX models' ``ValueError`` for a policy not in REMAT_POLICIES."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r} (use 'full' or 'dots')")


def run_pair(enabled: bool, policy: str, fn, *args):
    """``fn(*args)``; when ``enabled`` and the graph is recorded, under
    gradient checkpointing with ``policy``."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, context_fn=_dots_contexts)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
