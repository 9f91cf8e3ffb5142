"""Train state: model, EMA and optimizer, and the reference's optimization
defaults (port of ``latte_tpu/train/state.py``): AdamW at lr 1e-4 with
weight decay 0, EMA 0.9999, warmup-then-constant or cosine learning rate.

AdamW is the port's own :class:`AdamW` with optax's defaults (b1 0.9, b2
0.999, eps 1e-8, decoupled decay), as the JAX package uses ``optax.adamw``:
a library optimizer's arithmetic (``torch.optim.AdamW``'s with fp32
moments, optax's with ``adam_mu_dtype: bfloat16``), with no Pallas kernel
behind it on either side. The learning rate follows optax's step
semantics: the update of step ``n`` (counting from 0) uses
``schedule(n)``, so the first update under warmup uses a learning rate of 0.

The update reads its learning rate and bias corrections from device
scalars that the host writes before it (:meth:`AdamW.prepare`), so one
update runs on the device alone (:meth:`AdamW.apply`) and can be captured
in the train step's CUDA graph, as optax's count and learning rate live on
the device inside the JAX step's jit.

The optimizer holds the parameters that require a gradient: ``fixed_spatial``
freezes all but :func:`trainable_temporal_attn_mask`'s, which are then the
only ones updated and decayed (the JAX trainer's decay mask).

Over several GPUs the optimizer holds this rank's parts of them instead
(``dist.sharding.ShardedParams.leaves``: a ZeRO-1 slice or an FSDP shard,
each an alias of its parameter's storage), so its moments are that part's
alone; the arithmetic is elementwise, and so the same. A pipeline stage's
model holds its blocks alone, so its EMA copy and moments are the stage's.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

__all__ = [
    "AdamW",
    "TrainState",
    "make_lr_schedule",
    "make_optimizer",
    "create_train_state",
    "trainable_temporal_attn_mask",
    "update_ema",
]

Schedule = Callable[[int], float]


@dataclasses.dataclass
class TrainState:
    """``step`` counts the optimizer updates taken; ``model`` holds the fp32
    master parameters, ``ema`` their exponential moving average (a frozen
    copy of the model), ``optimizer`` the AdamW moments, ``schedule`` the
    learning rate by step."""

    step: int
    model: nn.Module
    ema: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule


def make_lr_schedule(
    lr: float = 1e-4,
    warmup_steps: int = 0,
    schedule: str = "warmup",
    decay_steps: int = 0,
    lr_min: float = 0.0,
) -> Schedule:
    """The reference's two learning-rate schedules, as optax builds them:

    - ``"warmup"``: linear warmup from 0 to ``lr`` over ``warmup_steps``,
      then constant;
    - ``"cosine"``: ``lr_min + (lr - lr_min)·(1 + cos(π·min(t, T)/T))/2``
      over ``decay_steps`` = T, after the same linear warmup.
    """
    if schedule not in ("warmup", "cosine"):
        raise NotImplementedError(f"lr schedule {schedule!r}")
    if schedule == "cosine" and decay_steps <= 0:
        raise ValueError("cosine schedule requires decay_steps (T_max) > 0")
    alpha = lr_min / lr if lr else 0.0

    def after_warmup(t: int) -> float:
        if schedule == "warmup":
            return lr
        frac = min(t, decay_steps) / decay_steps
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    def fn(step: int) -> float:
        if step < warmup_steps:
            return lr * step / warmup_steps
        return after_warmup(step - max(warmup_steps, 0))

    return fn


# the temporal blocks' attention: blocks.{odd}.attn.*
_TEMPORAL_ATTN = re.compile(r"^blocks\.\d*[13579]\.attn\.")


def trainable_temporal_attn_mask(model: nn.Module) -> Dict[str, bool]:
    """``fixed_spatial``'s mask by parameter name: True only for the
    temporal attention's parameters (the JAX mask's "temporal" and "attn" in
    the path), the ``attn.*`` parameters of the odd blocks."""
    return {name: bool(_TEMPORAL_ATTN.match(name)) for name, _ in model.named_parameters()}


# the parameters an update's temporaries cover at a time (elementwise: the
# chunking changes no number, and bounds the update's working memory)
_CHUNK = 1 << 27


def _chunks(params: list) -> list:
    """``params`` in runs of at most _CHUNK elements (a larger tensor alone)."""
    out, run, n = [], [], 0
    for p in params:
        if run and n + p.numel() > _CHUNK:
            out.append(run)
            run, n = [], 0
        run.append(p)
        n += p.numel()
    return out + [run] if run else out


class AdamW(torch.optim.Optimizer):
    """AdamW (optax's defaults, decoupled decay) whose update reads its
    step-dependent scalars from the device. The state keys are
    ``torch.optim.AdamW``'s (``step``, ``exp_avg``, ``exp_avg_sq``; ``step``
    a CPU tensor), and ``exp_avg`` keeps its type through ``state_dict`` /
    ``load_state_dict``.

    With fp32 moments (``mu_dtype`` fp32, the default) the arithmetic is
    ``torch.optim.AdamW``'s: the decay ``p·(1 - lr·wd)`` first, ``m`` a
    lerp towards the gradient, ``v = b2·v + (1 - b2)·g²``, then ``p +=
    (-lr/bc1)·m / (sqrt(v)/sqrt(bc2) + eps)``, its bias corrections in
    double precision, each scalar rounded to fp32 where it is used. (The
    product with -lr/bc1 is taken before the division, as the CPU's
    ``addcdiv`` takes it, in three ops where ``torch.optim.AdamW`` runs one
    ``addcdiv``; on the card that may round otherwise in the last bit.)

    With ``mu_dtype`` bf16 (``adam_mu_dtype: bfloat16``) it is
    ``optax.adamw(..., mu_dtype=...)``'s: the new moment is computed in fp32
    from the stored one (``b1·mu`` rounded to ``mu_dtype``, as a weakly
    typed product is in JAX) and the fp32 gradient; the bias-corrected
    update uses that fp32 moment, and only then is it stored rounded to
    ``mu_dtype``; the corrections are optax's fp32 ``1 - decay**count``. The
    second moment stays fp32: its increment, (1 - b2) = 0.1% of its size, is
    below bf16's resolution.

    :meth:`step` is :meth:`prepare` on the host, then :meth:`apply` on the
    device. ``prepare`` counts the update (every ``step`` counter) and
    writes each group's three scalars (learning rate, decay and bias
    corrections) into a device tensor; ``apply`` reads only tensors, so a
    CUDA graph that captured it applies each step's own learning rate and
    corrections when it is replayed after ``prepare``. ``apply`` updates
    the parameters a run of at most 2**27 elements at a time, so its
    temporaries take at most a few of those runs' bytes."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype: torch.dtype = torch.float32):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.mu_dtype = mu_dtype
        self._scalars: Dict[int, torch.Tensor] = {}  # per group, on its parameters' device
        self._count = 0.0

    def _values(self, group) -> tuple:
        """The group's scalars at the prepared count: fp32 moments
        ``(1 - lr·wd, -lr/bc1, sqrt(bc2))`` in double precision, as
        ``torch.optim.AdamW`` computes them; bf16 ones ``(-lr, bc1, bc2)``,
        the corrections in fp32 as optax computes ``decay**count``."""
        (b1, b2), lr = group["betas"], group["lr"]
        if self.mu_dtype == torch.float32:
            return 1 - lr * group["weight_decay"], -(lr / (1 - b1**self._count)), (1 - b2**self._count) ** 0.5
        count = np.float32(self._count)
        return (-lr, float(np.float32(1) - np.float32(b1) ** count), float(np.float32(1) - np.float32(b2) ** count))

    @torch.no_grad()
    def prepare(self) -> None:
        """The host's part of an update: ``count += 1`` on every moment's
        ``step`` counter (the count of the first update, 1, before any
        moment exists), and each group's scalars written on the device
        (``fill_``: no host sync)."""
        steps = [st["step"] for st in self.state.values() if "step" in st]
        if steps:
            torch._foreach_add_(steps, 1.0)
            self._count = steps[0].item()
        else:
            self._count = 1.0
        for i, group in enumerate(self.param_groups):
            if not group["params"]:
                continue
            scalars = self._scalars.get(i)
            if scalars is None:
                scalars = self._scalars[i] = torch.zeros(3, dtype=torch.float32, device=group["params"][0].device)
            for slot, value in zip(scalars, self._values(group)):
                slot.fill_(value)

    @torch.no_grad()
    def apply(self) -> None:
        """The device's part of an update, after :meth:`prepare`: every
        parameter with a gradient updated in place from its moments and the
        group's device scalars (a parameter's first update makes its moments,
        its ``step`` counter at the prepared count)."""
        for i, group in enumerate(self.param_groups):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(step=torch.tensor(self._count, device="cpu"),
                                         exp_avg=torch.zeros_like(p, dtype=self.mu_dtype),
                                         exp_avg_sq=torch.zeros_like(p))
            update = self._torch_update if self.mu_dtype == torch.float32 else self._optax_update
            for part in _chunks(params):
                update(group, part, [p.grad for p in part], [self.state[p]["exp_avg"] for p in part],
                       [self.state[p]["exp_avg_sq"] for p in part], *self._scalars[i])

    @staticmethod
    def _torch_update(group, params, grads, mus, nus, decay, neg_step, bc2_sqrt) -> None:
        b1, b2 = group["betas"]
        if group["weight_decay"]:
            torch._foreach_mul_(params, decay)
        torch._foreach_lerp_(mus, grads, 1 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, 1 - b2)
        denom = torch._foreach_sqrt(nus)
        torch._foreach_div_(denom, bc2_sqrt)
        torch._foreach_add_(denom, group["eps"])
        update = torch._foreach_mul(mus, neg_step)
        torch._foreach_div_(update, denom)
        del denom
        torch._foreach_add_(params, update)

    def _optax_update(self, group, params, grads, mus, nus, neg_lr, bc1, bc2) -> None:
        b1, b2 = group["betas"]
        # mu = (1 - b1)·g + b1·mu in fp32, b1·mu in mu's type (b1 too);
        # stored rounded, while the update goes on from the fp32 mu,
        # which becomes the update in place (one parameter-sized
        # temporary at a time beside it)
        b1_mu = torch.tensor(b1, dtype=self.mu_dtype).item()
        update = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(update, torch._foreach_mul(mus, b1_mu))
        torch._foreach_copy_(mus, update)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, g2)
        del g2
        torch._foreach_div_(update, bc1)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(update, denom)
        del denom
        if group["weight_decay"]:
            torch._foreach_add_(update, torch._foreach_mul(params, group["weight_decay"]))
        torch._foreach_mul_(update, neg_lr)
        torch._foreach_add_(params, update)

    @torch.no_grad()
    def step(self, closure=None):
        self.prepare()
        self.apply()

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)  # casts every moment to its parameter's type
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)


def make_optimizer(
    model: nn.Module, weight_decay: float = 0.0, mu_dtype: Optional[torch.dtype] = None, params=None
) -> torch.optim.Optimizer:
    """:class:`AdamW` with optax's defaults over the parameters that require
    a gradient (only they are decayed), or over ``params`` (a rank's parts
    of them); the learning rate is set before each update from the
    schedule. ``mu_dtype`` other than fp32 stores the first moment in that
    type."""
    if params is None:
        params = [p for p in model.parameters() if p.requires_grad]
    return AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
                 mu_dtype=mu_dtype or torch.float32)


def create_train_state(
    model: nn.Module, optimizer: torch.optim.Optimizer, schedule: Schedule, ema: Optional[nn.Module] = None
) -> TrainState:
    """EMA starts as a copy of the parameters (the reference's
    ``update_ema(..., decay=0)`` at init); ``ema`` gives that copy (made
    before the model was sharded, and sharded alike)."""
    if ema is None:
        ema = copy.deepcopy(model).requires_grad_(False)
    return TrainState(step=0, model=model, ema=ema, optimizer=optimizer, schedule=schedule)


@torch.no_grad()
def update_ema(ema: nn.Module, model: nn.Module, decay: float = 0.9999) -> None:
    """``ema ← decay·ema + (1 − decay)·params``, an fp32 lerp in place."""
    torch._foreach_lerp_(list(ema.parameters()), list(model.parameters()), 1.0 - decay)
