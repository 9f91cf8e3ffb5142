"""int8 flash attention for W8A8 serving: the CUDA kernels' wrapper and
their plain version.

The kernels replace the Pallas kernel ``_flash_int8_kernel`` of
``latte_tpu/kernels/attention.py`` (``:330``, launched at ``:462`` by
``flash_attention_int8``, ``:406``) and serve the fused int8 core
``int8_attention`` of ``latte_tpu/quant/int8.py`` (``:116``) too, which the
JAX wrapper falls back to and the model's short-sequence route runs:
``csrc/flash_attention_int8_tc.cu`` (int8 ``mma.sync`` on the tensor cores)
takes every call at head_dim 72 with 16-byte aligned operands, in both P·V
modes (P·V in int8 on the int8 tensor cores; in the "qk" mode in bf16
``mma.sync``, or for fp32 storage in register tiles on the CUDA cores),
``csrc/flash_attention_int8.cu`` (dp4a on the CUDA cores) other head dims
and misaligned views; :func:`int8_route` picks one before the launch. Both
quantize q, k, v per head at calibrated scales (``max(amax, 1e-8) / 127``,
round half to even, clip ±127), run QKᵀ as int8×int8→int32 and, with
``pv_int8``, P·V as well, P rounded to int8 at a per-row (fused) or
per-scale-block (flash) maximum; without it (the "qk" mode) P is rounded
to v's type and P·V summed in fp32.

``scale_block`` picks the arithmetic:

- ``None``: the fused core. One P scale per row, and the probabilities are
  normalised before they are rounded (``int8_attention``).
- an int: the flash kernel. The keys fall in blocks of ``scale_block`` (the
  last one shorter when it does not divide N); each block's P is rounded
  unnormalised at the block's maximum, and the blocks are joined by the
  online-softmax rescale.

The JAX flash wrapper uses blocks of ``min(1024, N)`` keys and falls back to
the fused core when N does not divide by that (:func:`flash_scale_block`).
Up to N = 1024 both arithmetics see one scale per row and agree to fp32
rounding (1.3e-7 relative with ``pv_int8``); in bf16 "qk" mode they differ
by ~3e-3, since one rounds bf16(p / l) and the other bf16(p) / l.

The wrapper launches the kernel :func:`int8_route` names for CUDA tensors
and runs the plain version for CPU tensors; there is no fallback from one
to the other. Both go through the custom op
``latte_tpu_torch::flash_attention_int8`` (:mod:`latte_tpu_torch.kernels.ops`;
:func:`launch_int8` its CUDA registration, :func:`plain_int8` its CPU one).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from latte_tpu_torch.kernels import build
from latte_tpu_torch.kernels.attention import TC_HEAD_DIM, _aligned

__all__ = [
    "flash_attention_int8",
    "int8_route",
    "int8_attention",
    "flash_scale_block",
    "quant_scale",
    "quantize_int8",
    "ieee_div",
]

MAX_HEAD_DIM = 128
FLASH_BLOCK = 1024  # the JAX wrapper's block_k
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ieee_div(a, b):
    """``a / b`` elementwise with one correctly rounded division, where one
    side is a Python number. ``tensor / number`` on CUDA and ``number /
    tensor`` anywhere multiply by a rounded reciprocal instead, which moves
    a quantization scale by an ulp against the JAX package's division."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def quant_scale(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale of an amax: ``max(amax, 1e-8) / 127`` in fp32."""
    return ieee_div(torch.clamp_min(amax.float(), 1e-8), 127.0)


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` in fp32, as integer values (round
    half to even, as ``jnp.round``); the caller casts to int8 where it needs to."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127)


def _int_dot(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum of integer-valued fp32 operands (|x| ≤ 127) with the JAX
    package's int32 accumulation: summed exactly in fp64, then rounded once
    to fp32, as ``int32.astype(float32)`` rounds."""
    return torch.einsum(equation, a.double(), b.double()).float()


def flash_scale_block(n: int) -> Optional[int]:
    """The P-scale block of the JAX flash wrapper at sequence length ``n``:
    ``min(1024, n)`` keys when ``n`` divides by it, else ``None`` (its
    fallback to the fused core, ``attention.py:428-433``)."""
    block = min(FLASH_BLOCK, n)
    return block if n % block == 0 else None


def _scales(q_amax, k_amax, v_amax, D: int):
    """Per-head fp32 (H,) scales: qs, ks, vs and the logit scale qs·ks·D^-½."""
    qs, ks, vs = quant_scale(q_amax), quant_scale(k_amax), quant_scale(v_amax)
    return qs, ks, vs, (qs * ks) * D**-0.5


def int8_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_amax: torch.Tensor,
    k_amax: torch.Tensor,
    v_amax: torch.Tensor,
    out_dtype: torch.dtype,
    pv_int8: bool = True,
    scale_block: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch int8 attention over (B, N, H, D) with calibrated per-head
    amax of shape (H,), at the rounding points of the JAX package.

    ``scale_block=None`` is ``int8_attention`` of ``latte_tpu/quant/int8.py``
    (the fused core); an int is ``_flash_int8_kernel`` with that many keys
    per P scale (see the module docstring). ``pv_int8=False`` keeps
    P·V in v's type with fp32 sums (the "qk" mode). The kernel's plain
    version, and the model's int8 attention when it runs ``plain``.
    """
    _, _, H, D = q.shape
    qs, ks, vs, ls = _scales(q_amax, k_amax, v_amax, D)
    head = lambda t: t.view(1, 1, H, 1)  # noqa: E731  (B, N, H, D) broadcast
    s = _int_dot("bnhd,bmhd->bhnm", quantize_int8(q, head(qs)), quantize_int8(k, head(ks)))
    s = s * ls.view(1, H, 1, 1)  # (B, H, N, N) fp32 logits
    vv = quantize_int8(v, head(vs)) if pv_int8 else v
    if scale_block is None:
        out = _fused_core(s, vv, pv_int8, out_dtype)
    else:
        out = _flash_blocks(s, vv, pv_int8, scale_block)
    if pv_int8:
        out = out * vs.view(1, H, 1, 1)
    return out.permute(0, 2, 1, 3).to(out_dtype)


def _fused_core(s: torch.Tensor, v: torch.Tensor, pv_int8: bool, out_dtype) -> torch.Tensor:
    """softmax, then P·V with one P scale per row (in "qk" mode P rounded to
    ``out_dtype``); (B, H, N, D) fp32, before the v scale."""
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    probs = p / p.sum(dim=-1, keepdim=True)
    if not pv_int8:
        return torch.einsum("bhnm,bmhd->bhnd", probs.to(out_dtype).float(), v.float())
    p_max = probs.amax(dim=-1, keepdim=True)
    p8 = torch.round(probs * ieee_div(127.0, p_max))
    return _int_dot("bhnm,bmhd->bhnd", p8, v) * ieee_div(p_max, 127.0)


def _flash_blocks(s: torch.Tensor, v: torch.Tensor, pv_int8: bool, block: int) -> torch.Tensor:
    """The flash kernel's loop over scale blocks; (B, H, N, D) fp32, before
    the v scale."""
    B, H, N, _ = s.shape
    acc = s.new_zeros((B, H, N, v.shape[-1]))
    m = s.new_full((B, H, N, 1), -1e30)
    l = s.new_zeros((B, H, N, 1))  # noqa: E741
    for j0 in range(0, N, block):
        sj, vj = s[..., j0:j0 + block], v[:, j0:j0 + block]
        m_new = torch.maximum(m, sj.amax(dim=-1, keepdim=True))
        p = torch.exp(sj - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)  # noqa: E741
        if pv_int8:
            p_max = torch.clamp_min(p.amax(dim=-1, keepdim=True), 1e-30)
            p8 = torch.round(p * ieee_div(127.0, p_max))
            pv = _int_dot("bhnm,bmhd->bhnd", p8, vj) * ieee_div(p_max, 127.0)
        else:
            pv = torch.einsum("bhnm,bmhd->bhnd", p.to(vj.dtype).float(), vj.float())
        acc = acc * alpha + pv
        m = m_new
    return acc / l


def _check_qkv(q, k, v, scale_block) -> None:
    """Validate q, k, v and the scale block as the kernels take them, on
    either device."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one (B, N, H, D) shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM or min(q.shape) < 1:
        raise ValueError(f"head_dim must be in [1, {MAX_HEAD_DIM}]; got shape {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last (head_dim) axis")
    if scale_block is not None and scale_block < 1:
        raise ValueError(f"scale_block must be None or positive; got {scale_block}")


def _check_amax(q, k, v, amaxes) -> None:
    """Validate the amax and the devices as the kernels take them."""
    H = q.shape[2]
    for a in amaxes:
        if a.shape != (H,) or not a.is_floating_point():
            raise ValueError(f"the amax of q, k and v must be float ({H},) tensors; got {tuple(a.shape)}")
    if any(t.device != q.device for t in (k, v, *amaxes)):
        raise ValueError("q, k, v and their amax must be on one device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention_int8 runs on cuda or cpu tensors, not {q.device}")


def int8_route(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pv_int8: bool, scale_block: Optional[int]
) -> str:
    """Which kernel takes these operands on the card: "tensor_core"
    (``csrc/flash_attention_int8_tc.cu``) at head_dim ``TC_HEAD_DIM``, bf16
    or fp32, whose base pointers and (batch, token, head) strides are all
    16-byte aligned, in either P·V mode (``pv_int8``) and at any
    ``scale_block``; else "cuda_core" (``csrc/flash_attention_int8.cu``:
    other head dims, any stride). Raises on what neither kernel takes; reads
    only shapes, strides and addresses, so it runs on CPU tensors too."""
    _check_qkv(q, k, v, scale_block)
    if q.shape[-1] == TC_HEAD_DIM and _aligned((q, k, v)):
        return "tensor_core"
    return "cuda_core"


def flash_attention_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_amax: torch.Tensor,
    k_amax: torch.Tensor,
    v_amax: torch.Tensor,
    pv_int8: bool = True,
    scale_block: Optional[int] = None,
) -> torch.Tensor:
    """int8 attention over (B, N, H, D) -> (B, N, H, D) in q's type, with the
    per-head amax (H,) of a calibration run; forward only (serving).

    q, k, v may be strided views with a contiguous head-dim axis (the model
    passes the column views of its fused qkv projection); the kernels
    quantize them as they load them. ``scale_block``: see the module
    docstring. ``flash_attention_int8.launches`` counts the kernel launches,
    ``.tc_launches`` those of the tensor-core kernel among them (see
    :func:`int8_route`). On the card, outside ``torch.export``, the custom
    op's CUDA registration is called directly (see ``adaln._ln_modulate_forward``).
    """
    if q.is_cuda and not torch.compiler.is_exporting():
        return launch_int8(q, k, v, q_amax, k_amax, v_amax, bool(pv_int8), scale_block)
    return torch.ops.latte_tpu_torch.flash_attention_int8.default(
        q, k, v, q_amax, k_amax, v_amax, bool(pv_int8), scale_block
    )


def check_int8(q, k, v, q_amax, k_amax, v_amax, scale_block: Optional[int]) -> None:
    """Validate the operands as the kernels take them (each of the custom
    op's registrations runs this)."""
    _check_qkv(q, k, v, scale_block)
    _check_amax(q, k, v, (q_amax, k_amax, v_amax))


def plain_int8(q, k, v, q_amax, k_amax, v_amax, pv_int8: bool, scale_block: Optional[int]) -> torch.Tensor:
    """The custom op's CPU registration: :func:`int8_attention` in q's type,
    contiguous."""
    check_int8(q, k, v, q_amax, k_amax, v_amax, scale_block)
    return int8_attention(q, k, v, q_amax, k_amax, v_amax, q.dtype, pv_int8, scale_block).contiguous()


def launch_int8(q, k, v, q_amax, k_amax, v_amax, pv_int8: bool, scale_block: Optional[int]) -> torch.Tensor:
    """The custom op's CUDA registration: the kernel :func:`int8_route`
    names, on the current stream; counts the launch."""
    route = int8_route(q, k, v, pv_int8, scale_block)
    _check_amax(q, k, v, (q_amax, k_amax, v_amax))
    lib = build.load_library()
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v) for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "tensor_core":  # the kernel computes each head's scales from its amax
        amax = [a.float().contiguous() for a in (q_amax, k_amax, v_amax)]
        err = lib.latte_flash_attention_int8_tc(
            _DTYPE_CODE[q.dtype], int(bool(pv_int8)), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(a.data_ptr() for a in amax), out.data_ptr(), B, N, H, D, scale_block or 0, strides,
            float(D**-0.5), q.device.index, stream,
        )
        build.check(err, "flash_attention_int8 (tensor cores)")
        flash_attention_int8.tc_launches += 1
    else:
        sc = torch.stack(_scales(q_amax, k_amax, v_amax, D), dim=-1).contiguous()  # (H, 4)
        err = lib.latte_flash_attention_int8(
            _DTYPE_CODE[q.dtype], int(bool(pv_int8)), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            sc.data_ptr(), out.data_ptr(), B, N, H, D, scale_block or 0, strides,
            q.device.index, stream,
        )
        build.check(err, "flash_attention_int8")
    flash_attention_int8.launches += 1
    return out


flash_attention_int8.launches = 0
flash_attention_int8.tc_launches = 0
