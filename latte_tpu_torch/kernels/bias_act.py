"""Bias + activation (+ gain + clamp), port of
``latte_tpu/kernels/bias_act.py``: the reference's nine activations with
their default alpha and gain, the bias axis, the output gain and the
symmetric clamp. Plain torch (no Pallas kernel stands behind it);
autograd gives every order of gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ActSpec:
    fn: Callable[[torch.Tensor, float], torch.Tensor]
    def_alpha: float = 0.0
    def_gain: float = 1.0


activation_funcs: Dict[str, ActSpec] = {
    "linear": ActSpec(lambda x, a: x),
    "relu": ActSpec(lambda x, a: F.relu(x), def_gain=math.sqrt(2)),
    "lrelu": ActSpec(lambda x, a: F.leaky_relu(x, a), def_alpha=0.2, def_gain=math.sqrt(2)),
    "tanh": ActSpec(lambda x, a: torch.tanh(x)),
    "sigmoid": ActSpec(lambda x, a: torch.sigmoid(x)),
    "elu": ActSpec(lambda x, a: F.elu(x, 1.0)),
    "selu": ActSpec(lambda x, a: F.selu(x)),
    "softplus": ActSpec(lambda x, a: F.softplus(x)),
    "swish": ActSpec(lambda x, a: F.silu(x), def_gain=math.sqrt(2)),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1, act: str = "linear",
             alpha: Optional[float] = None, gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """y = clamp(gain * act(x + b broadcast along ``dim``))."""
    spec = activation_funcs[act]
    alpha = spec.def_alpha if alpha is None else float(alpha)
    gain = spec.def_gain if gain is None else float(gain)
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape)
    x = spec.fn(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x
