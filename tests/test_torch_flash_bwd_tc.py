"""The bf16 tensor-core flash-attention backward (csrc/flash_attention_bwd_tc.cu)
on the CPU: its route, the operands the wrappers refuse, and the evidence
that its card check is sound.

The kernels run only on the card, where ``chip_smoke.py`` holds them
against the plain versions (``attention_bwd_dq_reference``,
``attention_bwd_dkv_reference``) with all but 1% of the outputs equal to the
bit. That is sound only if the backward's result does not depend on the
tile schedule: every rounding in it is elementwise (qs, p, ds and the
outputs), with no running maximum, so two schedules differ only by the
order of fp32 sums. Here the Pallas backward in interpret mode, at a block
of 16 and at a block of N, is held to the port's plain backward from the
same forward output and logsumexp, at that limit: all but 1% of the
elements equal to the bit, the rest one bf16 step apart at most.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latte_tpu.kernels import attention as jax_attn
from latte_tpu_torch.kernels import (
    attention_backward_reference,
    attention_delta,
    attention_reference,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)
from latte_tpu_torch.kernels.attention import (
    attention_bwd_dkv_reference,
    attention_bwd_dq_reference,
    backward_route,
)

torch.backends.cuda.matmul.allow_tf32 = False

SHARE_APART = 0.01  # chip_smoke.TILED_SHARE_APART


def _fused(B, N, H, D, dtype=torch.bfloat16, offset=0):
    """(q, k, v) as views of one (B, N, 3, H, D) tensor, ``offset`` elements
    into its storage, as the model hands them over."""
    numel = B * N * 3 * H * D
    buf = torch.zeros(numel + 8 + offset, dtype=dtype)
    shift = (16 - buf.data_ptr() % 16) % 16 // buf.element_size() + offset
    return buf[shift:shift + numel].view(B, N, 3, H, D).unbind(2)


def _operands(case):
    """q, k, v, dout and the fused gradient's dq, dk, dv for one route case."""
    B, N, H, D = 2, 256, 2, 72
    dtype, q_offset = torch.bfloat16, 0
    if case.startswith("bf16 N="):
        N = int(case.split("N=")[1].split()[0])
    elif case == "fp32":
        dtype = torch.float32
    elif case == "bf16 D=64":
        D = 64
    elif case == "bf16 q one element off":
        q_offset = 1
    q, k, v = _fused(B, N, H, D, dtype, q_offset)
    dout = torch.zeros((B, N, H, D), dtype=dtype)
    dq, dk, dv = _fused(B, N, H, D, dtype)
    if case == "bf16 dout one element off":
        dout = _fused(B, N, H, D, dtype, 1)[0]
    elif case == "bf16 dq token stride off":  # H*D + 4 elements: 8 bytes off a multiple of 16
        dq = torch.zeros((B, N, H * D + 4), dtype=dtype)[..., : H * D].unflatten(-1, (H, D))
    elif case == "bf16 dv head stride off":
        dv = torch.zeros((B, N, H, D + 4), dtype=dtype)[..., :D]
    return q, k, v, dout, dq, dk, dv


@pytest.mark.parametrize(
    "case, want",
    [
        ("bf16 N=256 (spatial)", "tensor_core"),
        ("bf16 N=16 (temporal)", "tensor_core"),
        ("bf16 N=200 (ragged)", "tensor_core"),
        ("bf16 N=40 (ragged temporal)", "tensor_core"),
        ("fp32", "fp32_tiled"),
        ("bf16 D=64", "cuda_core"),
        ("bf16 q one element off", "cuda_core"),
        ("bf16 dout one element off", "cuda_core"),
        ("bf16 dq token stride off", "cuda_core"),
        ("bf16 dv head stride off", "cuda_core"),
    ],
)
def test_backward_route(case, want):
    assert backward_route(*_operands(case)) == want


def test_backward_route_reads_only_the_gradients_a_kernel_writes():
    """The dQ kernel writes dq alone and the dK/dV kernel dk and dv: a
    misaligned dq sends only the dQ kernel to the CUDA cores."""
    q, k, v, dout, dq, dk, dv = _operands("bf16 dq token stride off")
    assert backward_route(q, k, v, dout, dq, None, None) == "cuda_core"
    assert backward_route(q, k, v, dout, None, dk, dv) == "tensor_core"


@pytest.mark.parametrize(
    "case, error",
    [
        ("float16", TypeError),
        ("dout shape", ValueError),
        ("dq dtype", ValueError),
        ("strided head_dim dk", ValueError),
        ("three dims", ValueError),
    ],
)
def test_backward_route_raises_on_what_neither_kernel_takes(case, error):
    q, k, v, dout, dq, dk, dv = _operands("bf16 N=16 (temporal)")
    if case == "float16":
        q, k, v, dout, dq, dk, dv = (t.half() for t in (q, k, v, dout, dq, dk, dv))
    elif case == "dout shape":
        dout = dout[:, :8]
    elif case == "dq dtype":
        dq = dq.float()
    elif case == "strided head_dim dk":
        dk = torch.zeros(dk.shape[:-1] + (2 * dk.shape[-1],), dtype=dk.dtype)[..., ::2]
    else:
        q, k, v, dout, dq, dk, dv = (t[0] for t in (q, k, v, dout, dq, dk, dv))
    with pytest.raises(error):
        backward_route(q, k, v, dout, dq, dk, dv)


def test_cpu_calls_move_no_launch_count():
    """On CPU tensors the wrappers run the plain versions, whatever the
    route, and count no launch."""
    B, N, H, D = 1, 16, 2, 72
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3, H, D)).astype(np.float32)).bfloat16()
    q, k, v = qkv.unbind(2)
    dout = torch.from_numpy(rng.standard_normal((B, N, H, D)).astype(np.float32)).bfloat16()
    out, lse = attention_reference(q, k, v, return_lse=True)
    delta = attention_delta(out, dout)
    dq, dk, dv = torch.empty_like(qkv).unbind(2)
    assert backward_route(q, k, v, dout, dq, dk, dv) == "tensor_core"
    counts = lambda: tuple(  # noqa: E731
        getattr(f, c) for f in (flash_attention_bwd_dq, flash_attention_bwd_dkv)
        for c in ("launches", "tc_launches")
    )
    before = counts()
    flash_attention_bwd_dq(q, k, v, dout, lse, delta, dq)
    flash_attention_bwd_dkv(q, k, v, dout, lse, delta, dk, dv)
    assert counts() == before
    assert torch.equal(dq, attention_bwd_dq_reference(q, k, v, lse, dout, delta))
    want_k, want_v = attention_bwd_dkv_reference(q, k, v, lse, dout, delta)
    assert torch.equal(dk, want_k) and torch.equal(dv, want_v)


def _steps_apart(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """How many bf16 values lie between two bf16 tensors, elementwise
    (+0 and -0 count as one value)."""
    def ordered(t):
        b = t.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)

    return (ordered(got) - ordered(want)).abs()


@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("block", ["16", "N"])
def test_pallas_backward_rounding_does_not_depend_on_the_tile_schedule(N, block):
    B, H, D = 1, 2, 72
    blk = 16 if block == "16" else N
    rng = np.random.default_rng(N)
    q, k, v, g = (
        torch.from_numpy(rng.standard_normal((B, N, H, D)).astype(np.float32)).bfloat16()
        for _ in range(4)
    )
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v, g))
    # the forward the vjp saves: Pallas at the same blocks (deterministic)
    out_j, lse_j = jax_attn._flash_forward(jq, jk, jv, blk, blk, interpret=True, rows=1)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_attn.flash_attention(a, b, c, block_q=blk, block_k=blk, bwd_impl="pallas"),
        jq, jk, jv,
    )
    want = vjp(jg)
    out = torch.from_numpy(np.array(out_j, np.float32)).bfloat16()
    lse = torch.from_numpy(np.array(lse_j, np.float32)).reshape(B * H, N)
    got = attention_backward_reference(q, k, v, out, lse, g)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.from_numpy(np.array(w, np.float32)).bfloat16()
        steps = _steps_apart(a, w)
        share = (steps > 0).double().mean().item()
        assert share <= SHARE_APART, f"{name}: {share:.4f} of the elements apart"
        assert steps.max().item() <= 1, f"{name}: {steps.max().item()} bf16 steps apart"
