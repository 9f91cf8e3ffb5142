"""The register-tiled fp32 flash-attention backward
(csrc/flash_attention_bwd_f32.cu) on the CPU: its route, the counters its
wrappers keep, and the evidence that its card check is sound.

The kernels run only on the card, where ``chip_smoke.py`` holds them
against the plain versions (``attention_bwd_dq_reference``,
``attention_bwd_dkv_reference``) within 1e-5 of the largest magnitude. In
fp32 every cast of the TPU kernels is the identity, so a tile schedule
changes nothing but the order of the fp32 sums. Here the Pallas backward in
interpret mode, at the new kernels' schedule (64-row tiles at N = 256, one
tile of N rows at N <= 64, one block at the ragged N = 200, the only one
the JAX wrapper takes there), is held to the port's plain backward from the
same forward output and logsumexp at that limit: relative 1e-5 of the
largest magnitude, elementwise, which is fp32 summation order.
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
    build,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)
from latte_tpu_torch.kernels.attention import (
    attention_bwd_dkv_reference,
    attention_bwd_dq_reference,
    backward_route,
)

torch.backends.cuda.matmul.allow_tf32 = False

FP32_REL = 1e-5  # chip_smoke.FP32_TOL


def _fused(B, N, H, D, dtype, offset=0):
    """(q, k, v) as views of one 16-byte aligned (B, N, 3, H, D) tensor,
    ``offset`` elements into its storage, as the model hands them over."""
    numel = B * N * 3 * H * D
    buf = torch.zeros(numel + 8 + offset, dtype=dtype)
    shift = (16 - buf.data_ptr() % 16) % 16 // buf.element_size() + offset
    return buf[shift:shift + numel].view(B, N, 3, H, D).unbind(2)


def _operands(case):
    """q, k, v, dout and the fused gradient's dq, dk, dv for one route case,
    named "<dtype> <what>"."""
    B, N, H, D = 2, 256, 2, 72
    dtype = torch.float32 if case.startswith("fp32") else torch.bfloat16
    if " N=" in case:
        N = int(case.split("N=")[1].split()[0])
    if "D=64" in case:
        D = 64
    q, k, v = _fused(B, N, H, D, dtype, 1 if "q one element off" in case else 0)
    dout = torch.zeros((B, N, H, D), dtype=dtype)
    dq, dk, dv = _fused(B, N, H, D, dtype)
    if "dout one element off" in case:
        dout = _fused(B, N, H, D, dtype, 1)[0]
    elif "dq token stride off" in case:  # H*D + 2 elements: 8 bytes (fp32) off a multiple of 16
        dq = torch.zeros((B, N, H * D + 2), dtype=dtype)[..., : H * D].unflatten(-1, (H, D))
    elif "dv head stride off" in case:
        dv = torch.zeros((B, N, H, D + 2), dtype=dtype)[..., :D]
    return q, k, v, dout, dq, dk, dv


@pytest.mark.parametrize(
    "case, want",
    [
        ("fp32 N=256 (spatial)", "fp32_tiled"),
        ("fp32 N=16 (temporal)", "fp32_tiled"),
        ("fp32 N=200 (ragged)", "fp32_tiled"),
        ("fp32 N=40 (ragged temporal)", "fp32_tiled"),
        ("fp32 N=65 (one past the temporal route)", "fp32_tiled"),
        ("fp32 q one element off", "cuda_core"),
        ("fp32 dout one element off", "cuda_core"),
        ("fp32 dq token stride off", "cuda_core"),
        ("fp32 dv head stride off", "cuda_core"),
        ("fp32 D=64", "cuda_core"),
        ("bf16 N=256 (spatial)", "tensor_core"),
        ("bf16 N=16 (temporal)", "tensor_core"),
        ("bf16 q one element off", "cuda_core"),
        ("bf16 D=64", "cuda_core"),
    ],
)
def test_backward_route(case, want):
    assert backward_route(*_operands(case)) == want


def test_fp32_route_reads_only_the_gradients_a_kernel_writes():
    """A misaligned dq sends only the dQ kernel to the CUDA-core kernel."""
    q, k, v, dout, dq, dk, dv = _operands("fp32 dq token stride off")
    assert backward_route(q, k, v, dout, dq, None, None) == "cuda_core"
    assert backward_route(q, k, v, dout, None, dk, dv) == "fp32_tiled"


def test_model_fused_gradient_takes_the_fp32_route():
    """The model's call (``_FusedAttention.backward``): q, k, v and dq, dk,
    dv are column views of fresh (B, N, 3, H, D) fp32 tensors, dout a fresh
    (B, N, H, D) one."""
    B, N, H, D = 2, 16, 16, 72
    qkv = torch.empty((B, N, 3, H, D))
    dqkv = torch.empty(qkv.shape)
    dout = torch.empty((B, N, H, D))
    assert backward_route(*qkv.unbind(2), dout, *dqkv.unbind(2)) == "fp32_tiled"


@pytest.mark.parametrize("N", [16, 200])
def test_cpu_calls_move_no_launch_count(N):
    """On CPU tensors the wrappers run the plain versions, whatever the
    route, and move none of the three launch counters."""
    B, H, D = 1, 2, 72
    rng = np.random.default_rng(N)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3, H, D)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    dout = torch.from_numpy(rng.standard_normal((B, N, H, D)).astype(np.float32))
    out, lse = attention_reference(q, k, v, return_lse=True)
    delta = attention_delta(out, dout)
    dq, dk, dv = torch.empty_like(qkv).unbind(2)
    assert backward_route(q, k, v, dout, dq, dk, dv) == "fp32_tiled"
    counts = lambda: tuple(  # noqa: E731
        getattr(f, c) for f in (flash_attention_bwd_dq, flash_attention_bwd_dkv)
        for c in ("launches", "tc_launches", "f32_launches")
    )
    before = counts()
    flash_attention_bwd_dq(q, k, v, dout, lse, delta, dq)
    flash_attention_bwd_dkv(q, k, v, dout, lse, delta, dk, dv)
    assert counts() == before
    assert torch.equal(dq, attention_bwd_dq_reference(q, k, v, lse, dout, delta))
    want_k, want_v = attention_bwd_dkv_reference(q, k, v, lse, dout, delta)
    assert torch.equal(dk, want_k) and torch.equal(dv, want_v)


@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_f32_entry_points_take_the_backward_arguments(kind):
    """The wrappers call the fp32 entry points with the arguments of the
    CUDA-core ones (``_launch_backward``), so ctypes declares them alike."""
    sig = build._SIGNATURES
    assert sig[f"latte_flash_attention_bwd_{kind}_f32"] == sig[f"latte_flash_attention_bwd_{kind}"]


@pytest.mark.parametrize("N, block", [(256, 64), (16, 16), (40, 40), (200, 200)])
def test_pallas_fp32_backward_matches_the_plain_backward(N, block):
    B, H, D = 1, 2, 72
    rng = np.random.default_rng(N)
    q, k, v, g = (
        torch.from_numpy(rng.standard_normal((B, N, H, D)).astype(np.float32)) for _ in range(4)
    )
    jq, jk, jv, jg = (jnp.asarray(t.numpy()) for t in (q, k, v, g))
    # the forward the vjp saves: Pallas at the same blocks (deterministic)
    out_j, lse_j = jax_attn._flash_forward(jq, jk, jv, block, block, interpret=True, rows=1)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_attn.flash_attention(
            a, b, c, block_q=block, block_k=block, bwd_impl="pallas"),
        jq, jk, jv,
    )
    want = vjp(jg)
    out = torch.from_numpy(np.array(out_j, np.float32))
    lse = torch.from_numpy(np.array(lse_j, np.float32)).reshape(B * H, N)
    got = attention_backward_reference(q, k, v, out, lse, g)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float64)
        a = a.double().numpy()
        np.testing.assert_allclose(a, w, rtol=0, atol=FP32_REL * np.abs(w).max(), err_msg=name)
