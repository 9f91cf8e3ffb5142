"""The bf16 tensor-core flash-attention forward (csrc/flash_attention_tc.cu)
on the CPU: its route, the operands the wrapper refuses, and a plain
mirror of its tile schedule against the Pallas kernel at the same tiling.

The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against the plain version and against ``attention_tiled_reference``, the
plain mirror of its arithmetic (an online softmax over 64-key tiles, p
rounded to bf16 at each tile's running maximum); here that mirror is held
against
``latte_tpu.kernels.attention._flash_forward`` in interpret mode at the same
``block_k``. That kernel needs N to be a multiple of ``block_k``, so ragged N
is held here against the plain version only.

Tolerances: fp32, 1e-5 relative (the same arithmetic summed in another
order, a few ulp apart); bf16, one rounding step: 2^-7 of the largest
magnitude (both sides round q, p and the output at the same points, so they
differ only where an fp32 difference of a few ulp moves a value across a
bf16 rounding boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latte_tpu.kernels import attention as jax_attn
from latte_tpu_torch.kernels import attention_reference, flash_attention
from latte_tpu_torch.kernels.attention import TC_TILE, attention_tiled_reference, forward_route

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP32_RTOL, FP32_ATOL = 1e-5, 1e-6
BF16_STEP = 2.0**-7


def _qkv_np(B, N, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, H, D)).astype(np.float32) for _ in range(3)]


def _fused_views(B, N, H, D, dtype=torch.bfloat16):
    """q, k, v as the model hands them over: views of one (B, N, 3, H, D)."""
    return torch.zeros((B, N, 3, H, D), dtype=dtype).unbind(2)


def _misaligned_offset(B, N, H, D):
    """Views whose base pointer sits 2 bytes past a 16-byte boundary."""
    n = B * N * H * D
    buf = torch.zeros(3 * n + 8, dtype=torch.bfloat16)
    shift = (16 - buf.data_ptr() % 16) % 16 // 2 + 1  # 16-aligned, then one element on
    return [buf[shift + i * n:shift + (i + 1) * n].view(B, N, H, D) for i in range(3)]


def _misaligned_token_stride(B, N, H, D):
    """A token stride of H*D + 4 elements: 8 bytes off a multiple of 16."""
    return [torch.zeros((B, N, H * D + 4), dtype=torch.bfloat16)[..., : H * D].unflatten(-1, (H, D))
            for _ in range(3)]


def _misaligned_head_stride(B, N, H, D):
    """A head stride of D + 4 elements."""
    return [torch.zeros((B, N, H, D + 4), dtype=torch.bfloat16)[..., :D] for _ in range(3)]


@pytest.mark.parametrize(
    "case, want",
    [
        ("bf16 N=16 (temporal)", "tensor_core"),
        ("bf16 N=24 (temporal, ragged)", "tensor_core"),
        ("bf16 N=256 (spatial)", "tensor_core"),
        ("bf16 N=1024 (T2V spatial)", "tensor_core"),
        ("bf16 D=64 (not built)", "cuda_core"),
        ("fp32 N=256", "fp32_tiled"),
        ("bf16 D=36", "cuda_core"),
        ("bf16 D=80 (not built)", "cuda_core"),
        ("bf16 misaligned storage offset", "cuda_core"),
        ("bf16 misaligned token stride", "cuda_core"),
        ("bf16 misaligned head stride", "cuda_core"),
    ],
)
def test_forward_route(case, want):
    B, H = 2, 2
    if case.startswith("bf16 N="):
        n = int(case.split("N=")[1].split()[0])
        qkv = _fused_views(B, n, H, 72)
    elif case.startswith("bf16 D=64"):
        qkv = [torch.zeros((B, 32, H, 64), dtype=torch.bfloat16) for _ in range(3)]
    elif case == "fp32 N=256":
        qkv = _fused_views(B, 256, H, 72, torch.float32)
    elif case == "bf16 D=36":
        qkv = _fused_views(B, 256, H, 36)
    elif case.startswith("bf16 D=80"):
        qkv = _fused_views(B, 256, H, 80)
    elif case == "bf16 misaligned storage offset":
        qkv = _misaligned_offset(B, 256, H, 72)
    elif case == "bf16 misaligned token stride":
        qkv = _misaligned_token_stride(B, 256, H, 72)
    else:
        qkv = _misaligned_head_stride(B, 256, H, 72)
    assert forward_route(*qkv) == want


def test_forward_route_ignores_strides_of_length_one_axes():
    """A length-1 axis never moves an address, so its stride may be odd."""
    q, k, v = _fused_views(1, 16, 1, 72)
    q = q.as_strided(q.shape, (7, q.stride(1), 3, 1))
    assert forward_route(q, k, v) == "tensor_core"


@pytest.mark.parametrize(
    "case, error",
    [
        ("float16", TypeError),
        ("mixed dtypes", TypeError),
        ("shape mismatch", ValueError),
        ("head_dim 160", ValueError),
        ("strided head_dim", ValueError),
        ("three dims", ValueError),
    ],
)
def test_wrapper_raises_on_what_neither_kernel_takes(case, error):
    q, k, v = (torch.zeros((1, 16, 2, 72), dtype=torch.bfloat16) for _ in range(3))
    if case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed dtypes":
        k = k.float()
    elif case == "shape mismatch":
        k = k[:, :8]
    elif case == "head_dim 160":
        q = k = v = torch.zeros((1, 16, 2, 160), dtype=torch.bfloat16)
    elif case == "strided head_dim":
        q = torch.zeros((1, 16, 2, 144), dtype=torch.bfloat16)[..., ::2]
    else:
        q, k, v = q[0], k[0], v[0]
    with pytest.raises(error):
        forward_route(q, k, v)
    with pytest.raises(error):
        flash_attention(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N, block_k", [(16, 16), (128, 64), (256, 64)])
def test_tiled_schedule_matches_pallas_at_the_same_block_k(dtype, N, block_k):
    B, H, D = 2, 2, 72
    q, k, v = _qkv_np(B, N, H, D, seed=N)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, want_lse = jax_attn._flash_forward(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), min(N, 64), block_k, interpret=True
    )
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    assert block_k == min(N, TC_TILE)  # the kernel's own tiling
    got, lse = attention_tiled_reference(tq, tk, tv, return_lse=True)
    want = np.asarray(want, np.float32)
    want_lse = np.asarray(want_lse, np.float32)[..., 0]
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=FP32_RTOL, atol=FP32_ATOL)
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=FP32_RTOL, atol=FP32_ATOL)
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_STEP * np.abs(want).max(), err
        # the same rounding points: all but a few elements equal to the bit
        # (the plain version, rounding p once per row, differs on ~20%)
        assert (got.float().numpy() != want).mean() <= 0.01
        # lse is fp32 from the same rounded q on both sides
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=FP32_RTOL, atol=1e-5)


@pytest.mark.parametrize("N", [16, 24, 64, 200, 256, 1024])
def test_tiled_schedule_within_the_card_tolerance_of_the_plain_version(N):
    """On the card the kernel is held against the plain version (one block
    of N keys) at 2^-6 of the largest magnitude in bf16 and the lse at 1e-4:
    rounding p per 64-key tile, at any N, ragged ones too, keeps the mirror
    of its schedule inside both; in fp32 the two agree to 1e-5."""
    B, H, D = 1, 2, 72
    q, k, v = map(torch.from_numpy, _qkv_np(B, N, H, D, seed=7 + N))
    got, lse = attention_tiled_reference(q, k, v, return_lse=True)
    want, want_lse = attention_reference(q, k, v, return_lse=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FP32_RTOL, atol=FP32_ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=FP32_RTOL, atol=FP32_ATOL)
    bq, bk, bv = (t.to(torch.bfloat16) for t in (q, k, v))
    got, lse = attention_tiled_reference(bq, bk, bv, return_lse=True)
    want, want_lse = attention_reference(bq, bk, bv, return_lse=True)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0**-6 * want.float().abs().max().item(), err
    assert (lse - want_lse).abs().max().item() <= 1e-4


def test_cpu_call_moves_no_launch_count():
    q, k, v = (t.contiguous() for t in _fused_views(1, 16, 2, 72))
    before = (flash_attention.launches, flash_attention.tc_launches)
    assert forward_route(q, k, v) == "tensor_core"
    assert torch.equal(flash_attention(q, k, v), attention_reference(q, k, v))
    assert (flash_attention.launches, flash_attention.tc_launches) == before
