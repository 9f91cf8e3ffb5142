"""The register-tiled fp32 flash-attention forward (csrc/flash_attention_f32.cu)
on the CPU: its route, the counters its wrapper keeps, and the evidence that
its card check is sound.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
the plain version (``attention_reference``) within 1e-5 of the largest
magnitude and its logsumexp within 1e-4. In fp32 every cast of the TPU
kernel is the identity, so a tile schedule changes nothing but the order of
the fp32 sums. Here the Pallas forward in interpret mode, at the new
kernel's schedule (128-query blocks and 64-key tiles at N = 256, one block
of N keys at N = 16, 40 and 200, the only one the JAX wrapper takes there),
is held to the port's plain version at that limit: 1e-5 of the largest
magnitude, elementwise, for the output and the logsumexp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latte_tpu.kernels import attention as jax_attn
from latte_tpu_torch.kernels import attention_reference, build, flash_attention
from latte_tpu_torch.kernels.attention import forward_route

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
    """q, k, v for one route case, named "<dtype> <what>"."""
    B, N, H, D = 2, 256, 2, 72
    dtype = torch.float32 if case.startswith("fp32") else torch.bfloat16
    if " N=" in case:
        N = int(case.split("N=")[1].split()[0])
    if "D=64" in case:
        D = 64
    q, k, v = _fused(B, N, H, D, dtype, 1 if "one element off" in case else 0)
    if "token stride off" in case:  # H*D + 2 elements: 8 bytes (fp32) off a multiple of 16
        k = torch.zeros((B, N, H * D + 2), dtype=dtype)[..., : H * D].unflatten(-1, (H, D))
    elif "head stride off" in case:
        v = torch.zeros((B, N, H, D + 2), dtype=dtype)[..., :D]
    return q, k, v


@pytest.mark.parametrize(
    "case, want",
    [
        ("fp32 N=256 (spatial)", "fp32_tiled"),
        ("fp32 N=16 (temporal)", "fp32_tiled"),
        ("fp32 N=200 (ragged)", "fp32_tiled"),
        ("fp32 N=40 (ragged temporal)", "fp32_tiled"),
        ("fp32 N=65 (one past the temporal route)", "fp32_tiled"),
        ("fp32 N=1024 (T2V spatial)", "fp32_tiled"),
        ("fp32 one element off", "cuda_core"),
        ("fp32 k token stride off", "cuda_core"),
        ("fp32 v head stride off", "cuda_core"),
        ("fp32 D=64", "cuda_core"),
        ("bf16 N=256 (spatial)", "tensor_core"),
        ("bf16 one element off", "cuda_core"),
    ],
)
def test_forward_route(case, want):
    assert forward_route(*_operands(case)) == want


def test_model_fused_views_take_the_fp32_route():
    """The model's call (``attention_qkv``): q, k, v are column views of a
    fresh (B, N, 3, H, D) fp32 tensor, at the trainer's temporal shape."""
    qkv = torch.empty((2, 16, 3, 16, 72))
    assert forward_route(*qkv.unbind(2)) == "fp32_tiled"


@pytest.mark.parametrize("N", [16, 200])
def test_cpu_calls_move_no_launch_count(N):
    """On CPU tensors the wrapper runs the plain version, whatever the
    route, and moves none of the three launch counters."""
    rng = np.random.default_rng(N)
    qkv = torch.from_numpy(rng.standard_normal((1, N, 3, 2, 72)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    assert forward_route(q, k, v) == "fp32_tiled"
    counts = lambda: tuple(getattr(flash_attention, c) for c in ("launches", "tc_launches", "f32_launches"))  # noqa: E731
    before = counts()
    out, lse = flash_attention(q, k, v, return_lse=True)
    assert counts() == before
    want, want_lse = attention_reference(q, k, v, return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)


def test_f32_entry_point_takes_the_forward_arguments():
    """The wrapper calls the fp32 entry point with the arguments of the
    tensor-core one (``_forward``), so ctypes declares them alike."""
    sig = build._SIGNATURES
    assert sig["latte_flash_attention_fwd_f32"] == sig["latte_flash_attention_fwd_tc"]


@pytest.mark.parametrize("N, block_q, block_k", [(256, 128, 64), (16, 16, 16), (40, 40, 40), (200, 200, 200)])
def test_pallas_fp32_forward_matches_the_plain_version(N, block_q, block_k):
    B, H, D = 1, 2, 72
    rng = np.random.default_rng(N)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, N, H, D)).astype(np.float32)) for _ in range(3))
    out_j, lse_j = jax_attn._flash_forward(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), block_q, block_k, interpret=True, rows=1
    )
    got, lse = attention_reference(q, k, v, return_lse=True)
    for name, a, w in (("out", got, out_j), ("lse", lse, np.asarray(lse_j).reshape(B * H, N))):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(a.double().numpy(), w, rtol=0, atol=FP32_REL * np.abs(w).max(), err_msg=name)
