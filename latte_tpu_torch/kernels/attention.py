"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd functions that join them.

Counterpart of ``latte_tpu/kernels/attention.py``. The kernels replace the
Pallas kernels of that file:

- ``csrc/flash_attention_tc.cu`` (bf16, tensor cores),
  ``csrc/flash_attention_f32.cu`` (fp32, register-tiled on the CUDA cores)
  and ``csrc/flash_attention.cu`` (the layouts neither takes, CUDA cores):
  ``_flash_kernel`` (``attention.py:56``, launched by ``_flash_forward`` at
  ``:122``); :func:`forward_route` picks one before the launch;
- ``csrc/flash_attention_bwd_tc.cu`` (bf16, tensor cores),
  ``csrc/flash_attention_bwd_f32.cu`` (fp32, register-tiled on the CUDA
  cores) and ``csrc/flash_attention_bwd.cu`` (the layouts neither takes,
  CUDA cores): ``_flash_bwd_dq_kernel`` (``:143``, launched at ``:257``)
  and ``_flash_bwd_dkv_kernel`` (``:184``, at ``:273``);
  :func:`backward_route` picks one before the launch.

:func:`flash_attention` and :func:`attention_qkv` are differentiable through
``torch.autograd.Function``\\ s, the counterpart of the ``custom_vjp`` at
``attention.py:299-327``: the forward saves q, k, v, the output and the fp32
logsumexp; the backward computes ``delta = rowsum(dO * O)`` in fp32 and
launches the dQ and dK/dV kernels. Each kernel wrapper launches its kernel
for CUDA tensors and runs its plain version for CPU tensors, nothing else:
there is no fallback from one to the other. The forward is the custom op
``latte_tpu_torch::flash_attention`` (:mod:`latte_tpu_torch.kernels.ops`:
:func:`launch_forward` its CUDA registration, :func:`plain_forward` its CPU
one), which the autograd functions call too; the backward kernels are
called directly.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from latte_tpu_torch.kernels import build

__all__ = [
    "flash_attention",
    "attention_qkv",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv",
    "attention_reference",
    "attention_tiled_reference",
    "attention_backward_reference",
    "attention_bwd_dq_reference",
    "attention_bwd_dkv_reference",
    "attention_delta",
    "forward_route",
    "backward_route",
]

MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core kernels (csrc/flash_attention_tc.cu, flash_attention_bwd_tc.cu)
# and the register-tiled fp32 ones (flash_attention_f32.cu,
# flash_attention_bwd_f32.cu): their one head_dim, Latte-XL/2's; and the
# tensor-core forward's keys of a K/V tile at N > TC_TILE
TC_HEAD_DIM = 72
TC_TILE = 64


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch attention over (B, N, H, D) with the kernel's numerics.

    q is scaled in fp32 and rounded back to its type, scores and sums are
    fp32, and the unnormalised probabilities are rounded to v's type before
    P·V: the TPU kernel with one K block (``block_k = N``, its default up to
    N = 1024). Returns ``out`` and, with ``return_lse``, the fp32 logsumexp
    of shape (B·H, N).
    """
    B, N, H, D = q.shape
    qs = (q.float() * D**-0.5).to(q.dtype).float()
    s = torch.einsum("bnhd,bmhd->bhnm", qs, k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    pv = torch.einsum("bhnm,bmhd->bhnd", p.to(v.dtype).float(), v.float())
    out = (pv / l).permute(0, 2, 1, 3).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).reshape(B * H, N).contiguous()


def attention_tiled_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The tensor-core forward's tile schedule in plain PyTorch: the
    rounding points of :func:`attention_reference`, but an online softmax
    over K/V tiles of ``TC_TILE`` keys (one tile of N keys up to
    ``TC_TILE``), p rounded to v's type at each tile's running maximum
    before P·V while l sums the unrounded p, m starting at -1e30. A ragged
    last tile's missing keys count for nothing, as the kernel's masked keys
    do. The TPU kernel at ``block_k = TC_TILE`` rounds at the same points.
    """
    B, N, H, D = q.shape
    block_k = min(N, TC_TILE)
    qs = (q.float() * D**-0.5).to(q.dtype).float().transpose(1, 2)  # (B, H, N, D)
    kt, vt = k.float().transpose(1, 2), v.float().transpose(1, 2)
    acc = torch.zeros((B, H, N, D), device=q.device)
    m = torch.full((B, H, N, 1), -1e30, device=q.device)
    l = torch.zeros((B, H, N, 1), device=q.device)  # noqa: E741
    for k0 in range(0, N, block_k):
        s = qs @ kt[:, :, k0:k0 + block_k].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)  # noqa: E741
        acc = acc * alpha + p.to(v.dtype).float() @ vt[:, :, k0:k0 + block_k]
        m = m_new
    out = (acc / l).transpose(1, 2).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).reshape(B * H, N)


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32, as the (B·H, N) rows the backward
    kernels read (the JAX code leaves it to XLA, ``attention.py:247-249``)."""
    B, N, H, _ = out.shape
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(B * H, N).contiguous()


def _backward_terms(q, k, v, lse, dout, delta):
    """fp32 (B, H, N, N) probabilities and ds, and the rounded scaled q, at
    the TPU kernels' rounding points."""
    B, N, H, D = q.shape
    qs = (q.float() * D**-0.5).to(q.dtype).float()
    s = torch.einsum("bnhd,bmhd->bhnm", qs, k.float())
    p = torch.exp(s - lse.reshape(B, H, N, 1))
    dp = torch.einsum("bnhd,bmhd->bhnm", dout.float(), v.float())
    ds = (p * (dp - delta.reshape(B, H, N, 1))).to(q.dtype).float()
    return qs, p, ds


def attention_bwd_dq_reference(q, k, v, lse, dout, delta) -> torch.Tensor:
    """The dQ kernel's plain version: ``dq = round(scale·ds·K)``."""
    _, _, ds = _backward_terms(q, k, v, lse, dout, delta)
    return (torch.einsum("bhnm,bmhd->bnhd", ds, k.float()) * q.shape[-1] ** -0.5).to(q.dtype)


def attention_bwd_dkv_reference(q, k, v, lse, dout, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's plain version: ``dk = round(dsᵀ·qs)``,
    ``dv = round(round(p)ᵀ·dO)``."""
    qs, p, ds = _backward_terms(q, k, v, lse, dout, delta)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qs).to(k.dtype)
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(dout.dtype).float(), dout.float()).to(v.dtype)
    return dk, dv


def attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of attention over (B, N, H, D) with the TPU
    kernels' rounding points (``_flash_backward``, ``attention.py:238``):
    ``qs = round(q·scale)``, ``p = exp(qs·Kᵀ − lse)`` in fp32,
    ``ds = round(p∘(dO·Vᵀ − Δ))``, ``dq = round(scale·ds·K)``,
    ``dk = round(dsᵀ·qs)``, ``dv = round(round(p)ᵀ·dO)``; all sums fp32.
    Returns ``(dq, dk, dv)``."""
    delta = attention_delta(out, dout)
    dq = attention_bwd_dq_reference(q, k, v, lse, dout, delta)
    return (dq, *attention_bwd_dkv_reference(q, k, v, lse, dout, delta))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Validate the operands as the kernels take them, on either device."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one (B, N, H, D) shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must all be float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k, v must be on one device")
    if q.shape[-1] > MAX_HEAD_DIM or min(q.shape) < 1:
        raise ValueError(f"head_dim must be in [1, {MAX_HEAD_DIM}]; got shape {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last (head_dim) axis")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")


def _check_grads(q, k, v, dout, grads) -> None:
    _check(q, k, v)
    for t in (dout, *grads):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("dout and the gradients must match q's shape, dtype and device")
        if t.stride(-1) != 1:
            raise ValueError("dout and the gradients need a contiguous last (head_dim) axis")


def _check_backward(q, k, v, dout, lse, delta, grads) -> None:
    _check_grads(q, k, v, dout, grads)
    B, N, H, _ = q.shape
    for t in (lse, delta):
        if t.shape != (B * H, N) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"lse and delta must be contiguous fp32 ({B * H}, {N}) tensors")


def forward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which forward kernel takes these operands on the card. At head_dim
    ``TC_HEAD_DIM`` with base pointers and (batch, token, head) strides all
    16-byte aligned (the kernels' 16-byte copies need that; a stride of a
    length-1 axis is never used): "tensor_core"
    (``csrc/flash_attention_tc.cu``) for bf16, "fp32_tiled"
    (``csrc/flash_attention_f32.cu``) for fp32. Everything else, in either
    dtype, is "cuda_core" (``csrc/flash_attention.cu``, any stride). Raises
    on what no kernel takes. Reads only shapes, strides and addresses, so it
    runs on CPU tensors too."""
    _check(q, k, v)
    if q.shape[-1] != TC_HEAD_DIM or not _aligned((q, k, v)):
        return "cuda_core"
    return "tensor_core" if q.dtype == torch.bfloat16 else "fp32_tiled"


def _aligned(operands) -> bool:
    """Every operand's base pointer and (batch, token, head) strides are
    16-byte aligned, as 16-byte copies need; a stride of a length-1 axis is
    never used."""
    for t in operands:
        per = 16 // t.element_size()  # elements in 16 bytes
        if t.data_ptr() % 16 or any(n > 1 and s % per for n, s in zip(t.shape[:3], t.stride())):
            return False
    return True


def backward_route(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    dq: Optional[torch.Tensor],
    dk: Optional[torch.Tensor],
    dv: Optional[torch.Tensor],
) -> str:
    """Which backward kernels take these operands on the card. At head_dim
    ``TC_HEAD_DIM`` with q, k, v, dout and the gradients all at 16-byte
    aligned base pointers and (batch, token, head) strides: "tensor_core"
    (``csrc/flash_attention_bwd_tc.cu``) for bf16, "fp32_tiled"
    (``csrc/flash_attention_bwd_f32.cu``) for fp32. Everything else, in
    either dtype (other head dims, a misaligned view), is "cuda_core"
    (``csrc/flash_attention_bwd.cu``, any stride). A gradient the kernel
    does not write is None (the dQ kernel writes dq alone, the dK/dV kernel
    dk and dv). Raises on what no kernel takes; reads only shapes, strides
    and addresses, so it runs on CPU tensors too."""
    grads = [t for t in (dq, dk, dv) if t is not None]
    _check_grads(q, k, v, dout, grads)
    if q.shape[-1] != TC_HEAD_DIM or not _aligned((q, k, v, dout, *grads)):
        return "cuda_core"
    return "tensor_core" if q.dtype == torch.bfloat16 else "fp32_tiled"


def _forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel (or, for CPU tensors, its plain version), through
    the custom op ``latte_tpu_torch::flash_attention``
    (:mod:`latte_tpu_torch.kernels.ops`), which ``torch.export`` keeps as
    one node. Each of the op's registrations validates the operands. On the
    card, outside an export, the op's CUDA registration is called directly
    (the dispatcher's trip to a Python registration costs the host-bound
    sampler its time; the launch and its count are the same)."""
    if q.is_cuda and not torch.compiler.is_exporting():
        out, lse = launch_forward(q, k, v, return_lse)
    else:
        out, lse = torch.ops.latte_tpu_torch.flash_attention.default(q, k, v, return_lse)
    return out, (lse if return_lse else None)


def plain_forward(q, k, v, return_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The custom op's CPU registration: :func:`attention_reference`, out
    contiguous, and an empty fp32 lse unless asked for."""
    _check(q, k, v)
    if return_lse:
        out, lse = attention_reference(q, k, v, return_lse=True)
        return out.contiguous(), lse
    return attention_reference(q, k, v).contiguous(), q.new_empty((0,), dtype=torch.float32)


def launch_forward(q, k, v, return_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The custom op's CUDA registration: the kernel :func:`forward_route`
    names (it validates the operands), on the current stream; counts the
    launch."""
    route = forward_route(q, k, v)
    lib = build.load_library()
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, N) if return_lse else (0,), dtype=torch.float32, device=q.device)
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, B, N, H, D,
        *(t.stride(i) for t in (q, k, v) for i in range(3)), float(D**-0.5),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if route == "tensor_core":
        build.check(lib.latte_flash_attention_fwd_tc(*args), "flash_attention (tensor cores)")
        flash_attention.tc_launches += 1
    elif route == "fp32_tiled":
        build.check(lib.latte_flash_attention_fwd_f32(*args), "flash_attention (fp32 tiles)")
        flash_attention.f32_launches += 1
    else:
        build.check(lib.latte_flash_attention_fwd(_DTYPE_CODE[q.dtype], *args), "flash_attention")
    flash_attention.launches += 1
    return out, lse


def _launch_backward(entry: str, q, k, v, dout, lse, delta, dq, dk, dv) -> None:
    """Call one backward entry point (the CUDA-core kernel's, or with the
    suffix "_tc" the tensor-core kernel's, "_f32" the register-tiled fp32
    kernel's: all take the same arguments); unused gradient slots are
    None."""
    B, N, H, D = q.shape
    ops = (q, k, v, dout, dq, dk, dv)
    strides = (ctypes.c_longlong * 21)(
        *(0 if t is None else t.stride(i) for t in ops for i in range(3))
    )
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = getattr(build.load_library(), entry)(
        _DTYPE_CODE[q.dtype], *map(ptr, (q, k, v, dout, lse, delta, dq, dk, dv)),
        B, N, H, D, strides, float(D**-0.5), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, entry)


def flash_attention_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    dq: torch.Tensor,
) -> torch.Tensor:
    """dQ of attention over (B, N, H, D), written into ``dq`` (which may be a
    strided view, e.g. of a fused (B, N, 3, H, D) gradient). ``lse`` and
    ``delta`` are fp32 (B·H, N). ``flash_attention_bwd_dq.launches`` counts
    the kernel launches, ``.tc_launches`` those of the tensor-core kernel
    and ``.f32_launches`` those of the register-tiled fp32 kernel among them
    (see :func:`backward_route`)."""
    _check_backward(q, k, v, dout, lse, delta, (dq,))
    route = backward_route(q, k, v, dout, dq, None, None)
    if q.device.type == "cpu":
        return dq.copy_(attention_bwd_dq_reference(q, k, v, lse, dout, delta))
    if route == "tensor_core":
        _launch_backward("latte_flash_attention_bwd_dq_tc", q, k, v, dout, lse, delta, dq, None, None)
        flash_attention_bwd_dq.tc_launches += 1
    elif route == "fp32_tiled":
        _launch_backward("latte_flash_attention_bwd_dq_f32", q, k, v, dout, lse, delta, dq, None, None)
        flash_attention_bwd_dq.f32_launches += 1
    else:
        _launch_backward("latte_flash_attention_bwd_dq", q, k, v, dout, lse, delta, dq, None, None)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    dk: torch.Tensor,
    dv: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV of attention over (B, N, H, D), written into ``dk`` and
    ``dv`` (strided views allowed). ``flash_attention_bwd_dkv.launches``
    counts the kernel launches, ``.tc_launches`` those of the tensor-core
    kernel and ``.f32_launches`` those of the register-tiled fp32 kernel
    among them."""
    _check_backward(q, k, v, dout, lse, delta, (dk, dv))
    route = backward_route(q, k, v, dout, None, dk, dv)
    if q.device.type == "cpu":
        want_k, want_v = attention_bwd_dkv_reference(q, k, v, lse, dout, delta)
        return dk.copy_(want_k), dv.copy_(want_v)
    if route == "tensor_core":
        _launch_backward("latte_flash_attention_bwd_dkv_tc", q, k, v, dout, lse, delta, None, dk, dv)
        flash_attention_bwd_dkv.tc_launches += 1
    elif route == "fp32_tiled":
        _launch_backward("latte_flash_attention_bwd_dkv_f32", q, k, v, dout, lse, delta, None, dk, dv)
        flash_attention_bwd_dkv.f32_launches += 1
    else:
        _launch_backward("latte_flash_attention_bwd_dkv", q, k, v, dout, lse, delta, None, dk, dv)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def _backward_into(q, k, v, out, lse, dout, dq, dk, dv, plain: bool) -> None:
    """The attention backward into dq, dk, dv: both kernels, or with
    ``plain`` the plain backward on any device."""
    if dout.dtype != q.dtype:
        dout = dout.to(q.dtype)
    if dout.stride(-1) != 1:  # e.g. expanded along head_dim: not readable by the kernels
        dout = dout.contiguous()
    if plain:
        for grad, want in zip((dq, dk, dv), attention_backward_reference(q, k, v, out, lse, dout)):
            grad.copy_(want)
        return
    delta = attention_delta(out, dout)
    flash_attention_bwd_dq(q, k, v, dout, lse, delta, dq)
    flash_attention_bwd_dkv(q, k, v, dout, lse, delta, dk, dv)


def _forward_with_lse(q, k, v, plain: bool):
    if plain:
        _check(q, k, v)
        return attention_reference(q, k, v, return_lse=True)
    return _forward(q, k, v, return_lse=True)


class _FlashAttention(torch.autograd.Function):
    """Attention over separate q, k, v; the gradients are new tensors."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward_with_lse(q, k, v, plain=False)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
        _backward_into(q, k, v, out, lse, dout, dq, dk, dv, plain=False)
        return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Attention over one (B, N, 3, H, D) qkv tensor; its gradient comes back
    as one tensor of that shape, written in place by the kernels."""

    @staticmethod
    def forward(ctx, qkv, plain):
        out, lse = _forward_with_lse(*qkv.unbind(2), plain=plain)
        ctx.save_for_backward(qkv, out, lse)
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        _backward_into(*qkv.unbind(2), out, lse, dout, *dqkv.unbind(2), plain=ctx.plain)
        return dqkv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Attention over (B, N, H, D) -> (B, N, H, D), plus the fp32 (B·H, N)
    logsumexp (not differentiable) when ``return_lse``.

    q, k, v may be strided views (the head-dim axis must be contiguous): the
    kernels read them in place. Differentiable: the backward runs the dQ and
    dK/dV kernels. Without autograd only the forward kernel runs, and the
    logsumexp is computed only when asked for. ``flash_attention.launches``
    counts the forward kernels' launches, ``flash_attention.tc_launches``
    those of the tensor-core kernel and ``flash_attention.f32_launches``
    those of the register-tiled fp32 kernel among them (see
    :func:`forward_route`).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v)
        return (out, lse) if return_lse else out
    out, lse = _forward(q, k, v, return_lse)
    return (out, lse) if return_lse else out


def attention_qkv(qkv: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Attention over the fused (B, N, 3, H, D) qkv projection -> (B, N, H, D),
    the model's call. Differentiable; the gradient of qkv is written by the
    backward kernels straight into one (B, N, 3, H, D) tensor. ``plain``
    runs the plain forward and backward on any device instead of the kernels
    (to hold the kernel path against them on the card)."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, H, D); got {tuple(qkv.shape)}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedAttention.apply(qkv, plain)
    q, k, v = qkv.unbind(2)
    if plain:
        _check(q, k, v)
        return attention_reference(q, k, v)
    return _forward(q, k, v, return_lse=False)[0]


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.f32_launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.tc_launches = 0
flash_attention_bwd_dq.f32_launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.tc_launches = 0
flash_attention_bwd_dkv.f32_launches = 0
