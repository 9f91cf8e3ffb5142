"""The serving path's hand-written kernels as ``torch.library`` custom ops.

``torch.export`` cannot trace a ``ctypes`` call on raw pointers (a fake
tensor has no storage), so the kernels of the sampler's path are declared
as custom ops, each one opaque node of an exported graph:

- ``latte_tpu_torch::flash_attention(q, k, v, return_lse) -> (out, lse)``:
  B1, the attention forward (``lse`` is empty unless asked for);
- ``latte_tpu_torch::ln_modulate(x, shift, scale) -> out``: B2;
- ``latte_tpu_torch::residual_ln_modulate(x, delta, gate, shift, scale) ->
  (y, out)``: B3;
- ``latte_tpu_torch::flash_attention_int8(q, k, v, q_amax, k_amax, v_amax,
  pv_int8, scale_block) -> out``: B6.

Each op is defined in the ``latte_tpu_torch`` library (``torch.library.
Library``) with three registrations; the dispatcher calls them directly,
with none of ``torch.library.custom_op``'s Python layers around them (those
cost the host-bound sampler ~10 µs a call). The CUDA one is the kernel's launch
(``launch_*`` in the kernel's module): it picks the route, launches the
kernel on ``torch.cuda.current_stream`` and adds one to the wrapper's launch
counters, so an exported program's launches are counted like eager ones.
The CPU one is the plain version. The fake one returns empty outputs of the
kernel's shapes, dtypes and (contiguous) layout. Each validates the operands
as the kernel takes them (the wrappers do not: on the card the route
function validates, once). There is no other device
and no fallback: a CUDA call whose library fails to build or launch raises.

The wrappers (``flash_attention``, ``attention_qkv``, ``ln_modulate``,
``residual_ln_modulate``, ``flash_attention_int8``) call these ops, and so do the forwards of their ``autograd.Function``\\ s;
on a CUDA tensor outside ``torch.export`` they call the CUDA registration
directly, without the dispatcher's trip to Python (the same launch and
count). The ops themselves have no autograd formula. The backward kernels (B4, B5)
stay ``ctypes`` calls inside the attention's ``autograd.Function``\\ s.
"""

from __future__ import annotations

import torch

from latte_tpu_torch.kernels import adaln, attention, attention_int8

__all__ = ["flash_attention", "ln_modulate", "residual_ln_modulate", "flash_attention_int8", "OPS"]

_LIB = torch.library.Library("latte_tpu_torch", "DEF")


def _fake_flash_attention(q, k, v, return_lse):
    attention._check(q, k, v)
    lse_shape = (q.shape[0] * q.shape[2], q.shape[1]) if return_lse else (0,)
    return q.new_empty(q.shape), q.new_empty(lse_shape, dtype=torch.float32)


def _fake_ln_modulate(x, shift, scale):
    adaln._check(x, (), (shift, scale))
    return x.new_empty(x.shape)


def _fake_residual_ln_modulate(x, delta, gate, shift, scale):
    adaln._check(x, (delta,), (gate, shift, scale))
    return x.new_empty(x.shape), x.new_empty(x.shape)


def _fake_flash_attention_int8(q, k, v, q_amax, k_amax, v_amax, pv_int8, scale_block):
    attention_int8.check_int8(q, k, v, q_amax, k_amax, v_amax, scale_block)
    return q.new_empty(q.shape)


# name: (schema, CPU registration (the plain version), CUDA registration
# (the launch), fake registration)
_DEFS = {
    "flash_attention": (
        "(Tensor q, Tensor k, Tensor v, bool return_lse) -> (Tensor, Tensor)",
        attention.plain_forward, attention.launch_forward, _fake_flash_attention,
    ),
    "ln_modulate": (
        "(Tensor x, Tensor shift, Tensor scale) -> Tensor",
        adaln.plain_ln_modulate, adaln.launch_ln_modulate, _fake_ln_modulate,
    ),
    "residual_ln_modulate": (
        "(Tensor x, Tensor delta, Tensor gate, Tensor shift, Tensor scale) -> (Tensor, Tensor)",
        adaln.plain_residual_ln_modulate, adaln.launch_residual_ln_modulate, _fake_residual_ln_modulate,
    ),
    "flash_attention_int8": (
        "(Tensor q, Tensor k, Tensor v, Tensor q_amax, Tensor k_amax, Tensor v_amax, bool pv_int8, "
        "int? scale_block) -> Tensor",
        attention_int8.plain_int8, attention_int8.launch_int8, _fake_flash_attention_int8,
    ),
}
for _name, (_schema, _plain, _launch, _fake) in _DEFS.items():
    _LIB.define(_name + _schema)
    _LIB.impl(_name, _plain, "CPU")
    _LIB.impl(_name, _launch, "CUDA")
    torch.library.register_fake(f"latte_tpu_torch::{_name}", _fake, lib=_LIB)

# the ops (OpOverloads), as the wrappers call them and an exported graph names them
flash_attention = torch.ops.latte_tpu_torch.flash_attention.default
ln_modulate = torch.ops.latte_tpu_torch.ln_modulate.default
residual_ln_modulate = torch.ops.latte_tpu_torch.residual_ln_modulate.default
flash_attention_int8 = torch.ops.latte_tpu_torch.flash_attention_int8.default
OPS = tuple(f"latte_tpu_torch::{name}" for name in _DEFS)
