"""The "qk" mode of the int8 flash-attention kernel on the tensor cores
(csrc/flash_attention_int8_tc.cu with ``pv_int8=False``: QKᵀ in int8, P
rounded to v's type, P·V summed in fp32) on the CPU: the functions it must
compute, held to the JAX package, the evidence that its card check can tell
them from a FlashAttention-2-style kernel, and the counters its wrapper
keeps.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
the plain version (``int8_attention``): in bf16 equal to the bit on all but
1% of the outputs, in fp32 within 1e-6 of the largest magnitude. Here the
Pallas int8 kernel in interpret mode with ``pv_int8=False``, at the route's
scale blocks (its ``block_k``: 32, N, and 1024 at N = 2048), and the JAX
fused core ``int8_attention(pv_int8=False)`` are held to the plain version
at the limits of ``tests/test_torch_int8_kernels.py``, which say why: fp32
1e-5 relative L2 and 2e-3 elementwise, bf16 1e-3 and 2^-7; in fp32 the L2
limit holds over the rows that no rounding moved, at most 1% of them moved
(``torch_port_util.close_int8``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close_int8, int8_inputs, qkv_views

from latte_tpu.kernels.attention import flash_attention_int8 as jax_flash_int8
from latte_tpu.quant.int8 import int8_attention as jax_int8_attention
from latte_tpu_torch.kernels import flash_attention_int8, int8_attention
from latte_tpu_torch.kernels.attention_int8 import int8_route

DTYPES = [pytest.param(jnp.float32, id="fp32"), pytest.param(jnp.bfloat16, id="bf16")]
TILE = 32  # keys of the kernel's K tiles


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N, block, H", [(256, 32, 2), (256, 256, 2), (2048, 1024, 1)])
def test_pallas_qk_at_the_routes_scale_blocks_matches_the_plain_version(N, block, H, dtype):
    """The flash rule in "qk" mode at one P scale per 32 keys (the kernel's
    K tile), per N keys (the flash route's main path) and per 1024 keys at N
    = 2048 (two scale blocks joined by the online rescale)."""
    jx, tx, amax = int8_inputs((1, N, H, 72), dtype, seed=N + block + 5)
    want = jax_flash_int8(*jx, *map(jnp.asarray, amax), dtype, pv_int8=False, block_q=N, block_k=block)
    got = int8_attention(*tx, *map(torch.from_numpy, amax), tx[0].dtype, False, block)
    close_int8(got.float(), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [16, 256])
def test_fused_qk_core_on_the_models_views_matches_the_plain_version(N, dtype):
    """``scale_block=None``, the rule ``attention_mode: auto`` takes at N =
    16 and 256: P = p / l rounded to v's type, then P·V in fp32, on the
    column views of a fused qkv as the kernel takes them."""
    jx, tx, amax = int8_inputs((2, N, 2, 72), dtype, seed=N + 7)
    views = qkv_views(2, N, 2, 72, tx[0].dtype)
    for view, x in zip(views, tx):
        view.copy_(x)
    want = jax_int8_attention(*jx, *map(jnp.asarray, amax), dtype, pv_int8=False)
    got = int8_attention(*views, *map(torch.from_numpy, amax), tx[0].dtype, False, None)
    close_int8(got.float(), want, dtype)


@pytest.mark.parametrize("rule", ["flash", "fused"])
def test_a_tile_maximum_moves_more_than_one_percent_of_the_bf16_outputs(rule):
    """The evidence that the card's bf16 check (equal to the bit on all but
    1%) can fail: p taken against the running maximum of each 32-key K tile,
    as a FlashAttention-2-style online softmax takes it (the flash rule at
    blocks of one tile), rounds bf16(exp(s - m_tile)) where the function
    rounds bf16(exp(s - m)), and moves far more than 1% of the outputs at a
    reduced spatial shape (30% and 48% here), while the function itself is
    deterministic. Each moved output moves by a bf16 step or so: within
    the 2^-6 of the largest magnitude that the card allows any bf16 kernel,
    so that limit alone could not tell the two apart."""
    _, tx, amax = int8_inputs((1, 256, 4, 72), jnp.bfloat16, seed=11)
    amax = [torch.from_numpy(a) for a in amax]
    block = 256 if rule == "flash" else None
    want = int8_attention(*tx, *amax, torch.bfloat16, False, block)
    tile_max = int8_attention(*tx, *amax, torch.bfloat16, False, TILE)
    assert torch.equal(int8_attention(*tx, *amax, torch.bfloat16, False, block), want)
    share = (tile_max != want).double().mean().item()
    assert share > 0.05, f"only {share:.4f} of the outputs moved"
    err = (tile_max.float() - want.float()).abs().max()
    assert err <= 2.0**-6 * want.float().abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_block", [None, 16, 8])
def test_cpu_qk_calls_move_no_launch_count(scale_block, dtype):
    """On CPU tensors the wrapper runs the plain version of the "qk" mode on
    the model's column views, though the route names the tensor cores, and
    moves neither launch counter."""
    rng = np.random.default_rng(9)
    q, k, v = qkv_views(2, 16, 2, 72, dtype)
    for view in (q, k, v):
        view.copy_(torch.from_numpy(rng.standard_normal(view.shape).astype(np.float32)))
    amax = [t.float().abs().amax(dim=(0, 1, 3)) for t in (q, k, v)]
    assert int8_route(q, k, v, False, scale_block) == "tensor_core"
    before = (flash_attention_int8.launches, flash_attention_int8.tc_launches)
    got = flash_attention_int8(q, k, v, *amax, False, scale_block)
    assert (flash_attention_int8.launches, flash_attention_int8.tc_launches) == before
    assert got.dtype == dtype and got.shape == (2, 16, 2, 72)
    assert torch.equal(got, int8_attention(q, k, v, *amax, dtype, False, scale_block))
