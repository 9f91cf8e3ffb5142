"""The int8 flash-attention kernel on the tensor cores
(csrc/flash_attention_int8_tc.cu) on the CPU: its route, the counters its
wrapper keeps, and the evidence that its card check is sound (the "qk"
mode's, P·V in the storage type, is in tests/test_torch_int8_qk_tc.py).

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
the plain version (``int8_attention``) in bf16 and, tightly, in fp32, and
against the dp4a kernel (csrc/flash_attention_int8.cu). It takes both P·V
modes at head_dim 72 in both storage types and at every P-scale block: one
per row (the fused core, ``scale_block=None``), one per N keys (the flash
route's main path) and smaller blocks. Here the Pallas int8 kernel in
interpret mode at those blocks (its ``block_k``) is held to the plain
version at the limits of ``tests/test_torch_int8_kernels.py``, which say
why: fp32 1e-5 relative L2 and 2e-3 elementwise, bf16 1e-3 and 2^-7. With
small scale blocks a row has many P scales, and where XLA's exp and
torch's differ by an ulp at a p·127/p_max on a half-integer, P rounds to
the neighbouring int8 value on one side: one such row among the 512 of a
(1, 256, 2) case moves the relative L2 of the whole by ~3e-5 (seen at N =
256, blocks of 32) while staying inside 2e-3 elementwise. So in fp32 the
L2 limit holds over the rows that no such rounding moved (each within
1e-5 of the largest magnitude), and at most 1% of the rows may be moved.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close_int8, int8_inputs, qkv_views

from latte_tpu.kernels.attention import flash_attention_int8 as jax_flash_int8
from latte_tpu.quant.int8 import int8_attention as jax_int8_attention
from latte_tpu_torch.kernels import attention_int8, flash_attention_int8, int8_attention
from latte_tpu_torch.kernels.attention_int8 import int8_route

DTYPES = [pytest.param(jnp.float32, id="fp32"), pytest.param(jnp.bfloat16, id="bf16")]


@pytest.mark.parametrize(
    "case, pv_int8, scale_block, want",
    [
        ("bf16 N=256", True, 256, "tensor_core"),
        ("fp32 N=256", True, 256, "tensor_core"),
        ("bf16 N=256", True, None, "tensor_core"),
        ("fp32 N=256", True, None, "tensor_core"),
        ("bf16 N=256", True, 32, "tensor_core"),
        ("fp32 N=2048", True, 1024, "tensor_core"),
        ("bf16 N=16", True, 16, "tensor_core"),
        ("bf16 N=16", True, None, "tensor_core"),
        ("bf16 N=1024", True, 1024, "tensor_core"),
        ("bf16 N=256", False, 256, "tensor_core"),
        ("fp32 N=16", False, None, "tensor_core"),
        ("fp32 N=2048", False, 1024, "tensor_core"),
        ("bf16 N=1024", False, 1024, "tensor_core"),
        ("bf16 N=256 one element off", False, 256, "cuda_core"),
        ("bf16 N=256 D=64", False, 256, "cuda_core"),
        ("bf16 N=256 one element off", True, 256, "cuda_core"),
        ("fp32 N=256 one element off", True, None, "cuda_core"),
        ("bf16 N=256 token stride off", True, 256, "cuda_core"),
        ("bf16 N=256 D=64", True, 256, "cuda_core"),
    ],
)
def test_int8_route(case, pv_int8, scale_block, want):
    dtype = torch.float32 if case.startswith("fp32") else torch.bfloat16
    N = int(case.split("N=")[1].split()[0])
    D = 64 if "D=64" in case else 72
    q, k, v = qkv_views(1, N, 2, D, dtype, 1 if "one element off" in case else 0)
    if "token stride off" in case:  # 2 H D + 4 elements: 8 bytes (bf16) off a multiple of 16
        q = torch.zeros((1, N, 2 * D + 4), dtype=dtype)[..., : 2 * D].unflatten(-1, (2, D))
    assert int8_route(q, k, v, pv_int8, scale_block) == want


def test_route_raises_on_what_no_kernel_takes():
    x = torch.zeros((1, 8, 2, 72))
    with pytest.raises(TypeError):
        int8_route(x.half(), x.half(), x.half(), True, None)
    with pytest.raises(ValueError, match="scale_block"):
        int8_route(x, x, x, True, 0)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 8, 72, 2)).transpose(2, 3)
        int8_route(t, t, t, True, None)


@pytest.mark.parametrize("scale_block", [None, 16, 8])
def test_cpu_calls_move_no_launch_count(scale_block):
    """On CPU tensors the wrapper runs the plain version on the model's
    column views, whatever the route, and moves neither launch counter."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 16, 3, 2, 72)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    amax = [t.abs().amax(dim=(0, 1, 3)) for t in (q, k, v)]
    assert int8_route(q, k, v, True, scale_block) == "tensor_core"
    before = (flash_attention_int8.launches, flash_attention_int8.tc_launches)
    got = flash_attention_int8(q, k, v, *amax, True, scale_block)
    assert (flash_attention_int8.launches, flash_attention_int8.tc_launches) == before
    assert torch.equal(got, int8_attention(q, k, v, *amax, q.dtype, True, scale_block))


@pytest.mark.parametrize("D", [72, 16])
def test_kernel_scales_equal_the_plain_versions(D):
    """The tensor-core kernel computes each head's scales from the amax
    (``head_scales``): max(amax, 1e-8) / 127 and (qs·ks)·D^-½, one
    correctly rounded fp32 operation each, D^-½ rounded to fp32 by the
    wrapper. In numpy fp32 that equals the plain version's ``_scales`` to
    the bit, tiny and zero amax too."""
    rng = np.random.default_rng(D)
    amax = [np.abs(rng.standard_normal(64) * 10 ** rng.uniform(-9, 3, 64)).astype(np.float32)
            for _ in range(3)]
    amax[0][:2] = [0.0, 1e-9]
    want = attention_int8._scales(*map(torch.from_numpy, amax), D)
    s = [np.maximum(a, np.float32(1e-8)) / np.float32(127) for a in amax]
    got = (*s, (s[0] * s[1]) * np.float32(D**-0.5))
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N, block", [(256, 256), (256, 64), (256, 32), (16, 16), (16, 8)])
def test_pallas_int8_at_the_routes_scale_blocks_matches_the_plain_version(N, block, dtype):
    """The flash rule at one P scale per N keys (the main path) and per
    smaller blocks, joined by the online rescale."""
    jx, tx, amax = int8_inputs((1, N, 2, 72), dtype, seed=N + block)
    want = jax_flash_int8(*jx, *map(jnp.asarray, amax), dtype, pv_int8=True, block_q=N, block_k=block)
    got = int8_attention(*tx, *map(torch.from_numpy, amax), tx[0].dtype, True, block)
    close_int8(got.float(), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [16, 40, 256])
def test_fused_core_at_the_routes_lengths_matches_the_plain_version(N, dtype):
    """``scale_block=None``: one P scale per row, P normalised first, at the
    temporal N = 16, a ragged N = 40 and the spatial N = 256."""
    jx, tx, amax = int8_inputs((1, N, 2, 72), dtype, seed=N + 3)
    want = jax_int8_attention(*jx, *map(jnp.asarray, amax), dtype, pv_int8=True)
    got = int8_attention(*tx, *map(torch.from_numpy, amax), tx[0].dtype, True, None)
    close_int8(got.float(), want, dtype)

