"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``latte_tpu/kernels/attention.py`` (forward only). The kernel,
``csrc/flash_attention.cu``, replaces the Pallas ``_flash_kernel``
(``attention.py:56``, launched by ``_flash_forward`` at ``:122``). It is
bound by bytes on the H100 at Latte's shapes (see the note in the source).

:func:`flash_attention` launches the kernel for a CUDA tensor and runs
:func:`attention_reference` for a CPU tensor, nothing else: there is no
fallback from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from latte_tpu_torch.kernels import build

__all__ = ["flash_attention", "attention_reference"]

MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    return out, (m + torch.log(l)).reshape(B * H, N)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Validate the operands as the kernel takes them, on either device."""
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


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Attention over (B, N, H, D) -> (B, N, H, D), plus the fp32 (B·H, N)
    logsumexp when ``return_lse``.

    q, k, v may be strided views (the head-dim axis must be contiguous): the
    kernel reads them in place. ``flash_attention.launches`` counts the
    kernel launches.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, return_lse)
    lib = build.load_library()
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse: Optional[torch.Tensor] = (
        torch.empty((B * H, N), dtype=torch.float32, device=q.device) if return_lse else None
    )
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    err = lib.latte_flash_attention_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, N, H, D, *strides, float(D**-0.5),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
