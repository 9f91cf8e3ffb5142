"""Fused adaLN glue: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``latte_tpu/kernels/adaln.py``. The kernels in
``csrc/adaln.cu`` replace the Pallas ``_ln_mod_kernel`` (``adaln.py:49``,
launched by ``_ln_modulate_fwd_impl`` at ``:111``) and ``_res_ln_mod_kernel``
(``adaln.py:59``, launched by ``_res_ln_modulate_fwd_impl`` at ``:139``).
Both stream their rows once and are bound by bytes on the H100. Each has
two routes, chosen by :func:`adaln_route` before the launch: "vector" (a
warp holds a row in registers, 8- or 16-byte accesses; the registry's widths
on aligned layouts, which is every call the model makes) and "generic" (the
first versions: any width up to ``MAX_DIM``, any layout).

- :func:`ln_modulate`            out = LN(x) * (1 + scale) + shift
- :func:`residual_ln_modulate`   y = x + gate * delta (rounded to x's type),
                                 out = LN(y) * (1 + scale) + shift

LN has no affine terms, eps 1e-6, fp32 two-pass statistics E[(x - mu)^2].
x and delta are (B, N, D) contiguous; shift, scale and gate are (B, D) with a
contiguous last axis (column chunks of the modulation output are fine) and
broadcast over N. A wrapper launches the kernel its route names for CUDA
tensors and runs the plain version for CPU tensors, nothing else, through
the custom ops ``latte_tpu_torch::ln_modulate`` and
``::residual_ln_modulate`` (:mod:`latte_tpu_torch.kernels.ops`; the
``launch_*`` functions are their CUDA registrations).

Both are differentiable. As in the JAX package, whose backward is jnp and not
Pallas, the backward is plain PyTorch in fp32 with the same saved residuals
(x, or y) and the same final casts to each input's type.
"""

from __future__ import annotations

from typing import Tuple

import torch

from latte_tpu_torch.kernels import build

__all__ = [
    "adaln_route",
    "ln_modulate",
    "residual_ln_modulate",
    "ln_modulate_reference",
    "residual_ln_modulate_reference",
]

EPS = 1e-6
MAX_DIM = 1536  # 8 rows of fp32 in the generic kernel's 48 KB of shared memory
# widths the vector kernels are built for: the registry's S, B, L and XL
VEC_DIMS = (384, 768, 1024, 1152)
VEC_WIDTH = 4  # elements a lane reads at once: 8 bytes of bf16, 16 of fp32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ln_modulate_reference(
    x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    norm = (x32 - mu) * torch.rsqrt(var + EPS)
    out = norm * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return out.to(x.dtype)


def residual_ln_modulate_reference(
    x: torch.Tensor,
    delta: torch.Tensor,
    gate: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    y = (x.float() + gate.float()[:, None, :] * delta.float()).to(x.dtype)
    return y, ln_modulate_reference(y, shift, scale)


def _check(x: torch.Tensor, rows, vecs) -> int:
    """Validate the operands as the kernel takes them, on either device, so a
    CPU run rehearses the layouts; return the common row stride of the vectors."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, D); got {tuple(x.shape)}")
    B, N, D = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    for t in rows:
        if t.shape != x.shape:
            raise ValueError(f"expected {tuple(x.shape)}; got {tuple(t.shape)}")
    for t in vecs:
        if t.shape != (B, D):
            raise ValueError(f"expected a ({B}, {D}) vector; got {tuple(t.shape)}")
    for t in (*rows, *vecs):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError("all operands must share x's dtype and device")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"adaLN kernels run on cuda or cpu tensors, not {x.device}")
    if D > MAX_DIM:
        raise ValueError(f"D = {D} exceeds the kernel's {MAX_DIM}")
    if not all(t.is_contiguous() for t in (x, *rows)):
        raise ValueError("x (and delta) must be contiguous")
    vec_strides = [t.stride(0) for t in vecs]  # a list: symbolic strides do not hash
    if any(t.stride(1) != 1 for t in vecs) or any(st != vec_strides[0] for st in vec_strides):
        raise ValueError("shift/scale/gate need a contiguous last axis and one row stride")
    return vec_strides[0]


def adaln_route(x: torch.Tensor, rows, vecs) -> str:
    """Which kernel takes these operands on the card: "vector"
    (``*_vec_kernel`` in ``csrc/adaln.cu``) when D is one of ``VEC_DIMS``,
    every base pointer (x, the ``rows`` and the ``vecs``; the outputs are
    fresh allocations) is aligned to ``VEC_WIDTH`` elements, 8 bytes in bf16
    and 16 in fp32, and so is the vectors' row stride; else "generic" (the
    first versions, any width up to ``MAX_DIM``). ``rows`` are delta for
    residual_ln_modulate, ``vecs`` shift and scale (gate first for
    residual_ln_modulate). Raises on what neither kernel takes. Reads only
    shapes, strides, dtypes and addresses, so it runs on CPU tensors too."""
    vec_stride = _check(x, rows, vecs)
    aligned = all(t.data_ptr() % (VEC_WIDTH * t.element_size()) == 0 for t in (x, *rows, *vecs))
    if x.shape[-1] in VEC_DIMS and aligned and vec_stride % VEC_WIDTH == 0:
        return "vector"
    return "generic"


def _ln_modulate_forward(x, shift, scale) -> torch.Tensor:
    """The ln_modulate kernel (or, for CPU tensors, its plain version),
    through the custom op ``latte_tpu_torch::ln_modulate``, each of whose
    registrations validates the operands. On the card, outside
    ``torch.export``, the op's CUDA registration is called directly: the
    dispatcher's trip to a Python registration costs the host-bound sampler
    its time, and the launch and its count are the same."""
    if x.is_cuda and not torch.compiler.is_exporting():
        return launch_ln_modulate(x, shift, scale)
    return torch.ops.latte_tpu_torch.ln_modulate.default(x, shift, scale)


def _residual_ln_modulate_forward(x, delta, gate, shift, scale):
    """The residual_ln_modulate kernel (or, for CPU tensors, its plain
    version), through the custom op ``latte_tpu_torch::residual_ln_modulate``
    (on the card, outside an export, its CUDA registration directly; see
    :func:`_ln_modulate_forward`)."""
    if x.is_cuda and not torch.compiler.is_exporting():
        return launch_residual_ln_modulate(x, delta, gate, shift, scale)
    return torch.ops.latte_tpu_torch.residual_ln_modulate.default(x, delta, gate, shift, scale)


def plain_ln_modulate(x, shift, scale) -> torch.Tensor:
    """The ln_modulate op's CPU registration: the operands validated as the
    kernel takes them, then :func:`ln_modulate_reference`."""
    _check(x, (), (shift, scale))
    return ln_modulate_reference(x, shift, scale)


def plain_residual_ln_modulate(x, delta, gate, shift, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual_ln_modulate op's CPU registration (see
    :func:`plain_ln_modulate`)."""
    _check(x, (delta,), (gate, shift, scale))
    return residual_ln_modulate_reference(x, delta, gate, shift, scale)


def launch_ln_modulate(x, shift, scale) -> torch.Tensor:
    """The ln_modulate op's CUDA registration: the kernel :func:`adaln_route`
    names (it validates the operands), on the current stream; counts the
    launch."""
    route = adaln_route(x, (), (shift, scale))
    B, N, D = x.shape
    out = torch.empty_like(x)
    lib = build.load_library()
    entry = lib.latte_ln_modulate_vec if route == "vector" else lib.latte_ln_modulate
    err = entry(
        _DTYPE_CODE[x.dtype], x.data_ptr(), shift.data_ptr(), scale.data_ptr(),
        out.data_ptr(), B, N, D, shift.stride(0), EPS, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, f"ln_modulate ({route})")
    ln_modulate.vec_launches += route == "vector"
    ln_modulate.launches += 1
    return out


def launch_residual_ln_modulate(x, delta, gate, shift, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual_ln_modulate op's CUDA registration (see
    :func:`launch_ln_modulate`)."""
    route = adaln_route(x, (delta,), (gate, shift, scale))
    B, N, D = x.shape
    y = torch.empty_like(x)
    out = torch.empty_like(x)
    lib = build.load_library()
    entry = (lib.latte_residual_ln_modulate_vec if route == "vector"
             else lib.latte_residual_ln_modulate)
    err = entry(
        _DTYPE_CODE[x.dtype], x.data_ptr(), delta.data_ptr(), gate.data_ptr(),
        shift.data_ptr(), scale.data_ptr(), y.data_ptr(), out.data_ptr(), B, N, D,
        gate.stride(0), EPS, x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, f"residual_ln_modulate ({route})")
    residual_ln_modulate.vec_launches += route == "vector"
    residual_ln_modulate.launches += 1
    return y, out


def _ln_mod_backward(y, scale, g_out):
    """VJP of ``out = LN(y)·(1+scale)+shift`` in fp32 (``_ln_mod_bwd_math``,
    ``adaln.py:165-180``): with n = LN(y) and dn = g·(1+scale),
    ``dy = rstd·(dn − mean(dn) − n·mean(dn·n))``; returns (dy, dshift, dscale)."""
    y32, g32 = y.float(), g_out.float()
    mu = y32.mean(dim=-1, keepdim=True)
    var = (y32 - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + EPS)
    norm = (y32 - mu) * rstd
    dshift = g32.sum(dim=1)
    dscale = (g32 * norm).sum(dim=1)
    dn = g32 * (1.0 + scale.float()[:, None, :])
    dy = rstd * (dn - dn.mean(dim=-1, keepdim=True) - norm * (dn * norm).mean(dim=-1, keepdim=True))
    return dy, dshift, dscale


class _LnModulate(torch.autograd.Function):
    """Forward: the kernel. Backward: plain fp32 math, saving x (``_ln_modulate_bwd``)."""

    @staticmethod
    def forward(ctx, x, shift, scale):
        ctx.save_for_backward(x, shift, scale)
        return _ln_modulate_forward(x, shift, scale)

    @staticmethod
    def backward(ctx, g_out):
        x, shift, scale = ctx.saved_tensors
        dx, dshift, dscale = _ln_mod_backward(x, scale, g_out)
        return dx.to(x.dtype), dshift.to(shift.dtype), dscale.to(scale.dtype)


class _ResidualLnModulate(torch.autograd.Function):
    """Forward: the kernel. Backward: plain fp32 math, saving y
    (``_res_ln_modulate_bwd``, ``adaln.py:225-241``)."""

    @staticmethod
    def forward(ctx, x, delta, gate, shift, scale):
        y, out = _residual_ln_modulate_forward(x, delta, gate, shift, scale)
        ctx.save_for_backward(y, delta, gate, shift, scale)
        return y, out

    @staticmethod
    def backward(ctx, g_y, g_out):
        y, delta, gate, shift, scale = ctx.saved_tensors
        dy, dshift, dscale = _ln_mod_backward(y, scale, g_out)
        dy = dy + g_y.float()
        ddelta = dy * gate.float()[:, None, :]
        dgate = (dy * delta.float()).sum(dim=1)
        return (
            dy.to(y.dtype), ddelta.to(delta.dtype), dgate.to(gate.dtype),
            dshift.to(shift.dtype), dscale.to(scale.dtype),
        )


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``LN(x) * (1 + scale) + shift`` in one pass over x; differentiable.
    ``ln_modulate.launches`` counts the kernel launches, ``.vec_launches``
    those on the vector route among them."""
    if _needs_grad(x, shift, scale):
        return _LnModulate.apply(x, shift, scale)
    return _ln_modulate_forward(x, shift, scale)


def residual_ln_modulate(
    x: torch.Tensor,
    delta: torch.Tensor,
    gate: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated residual + LN + modulate in one pass: returns ``(y, out)``;
    differentiable. ``residual_ln_modulate.launches`` counts the kernel
    launches, ``.vec_launches`` those on the vector route among them."""
    if _needs_grad(x, delta, gate, shift, scale):
        return _ResidualLnModulate.apply(x, delta, gate, shift, scale)
    return _residual_ln_modulate_forward(x, delta, gate, shift, scale)


ln_modulate.launches = ln_modulate.vec_launches = 0
residual_ln_modulate.launches = residual_ln_modulate.vec_launches = 0
