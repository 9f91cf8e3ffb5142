"""Kernel B6, int8 flash attention: the plain version beside its CUDA kernel
(``latte_tpu_torch.kernels.int8_attention``) against the JAX package's two
int8 routes on the same numpy inputs and calibrated amax: the Pallas
``flash_attention_int8`` (interpret mode on the CPU) at the flash wrapper's
scale block, and the fused-XLA ``int8_attention`` at ``scale_block=None``;
and the wrapper's checks. The kernel itself runs only on the card, where
chip_smoke.py holds it against this plain version.

Tolerances (relative L2 of the difference over the JAX side's norm, and an
elementwise cap relative to the JAX side's largest magnitude):
- fp32: 1e-5 and 2e-3. The int32 sums are exact on both sides; exp and the
  fp32 sums of l and of P·V differ by an ulp or so (measured ≤ 4.6e-7
  relative). Where p·127 lies within that of a half-integer, P rounds to
  the neighbouring int8 value on one side, which moves one output row by
  |v|/(127·l): up to ~2e-3 of the output at N = 16 (l ≈ 5), far less at
  larger N.
- bf16: 1e-3 and 2^-7. The same, plus the final cast, where a value within
  an ulp of a bf16 rounding boundary rounds to the neighbouring bf16 value
  (measured ≤ 1.9e-4 relative, 3.8e-3 elementwise). The two JAX routes
  differ by ~3e-3 relative in bf16 "qk" mode, so each route is held to its
  own twin, tightly enough to tell them apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close

from latte_tpu.kernels.attention import flash_attention_int8 as jax_flash_int8
from latte_tpu.quant.int8 import int8_attention as jax_int8_attention
from latte_tpu_torch.kernels import flash_attention_int8, flash_scale_block, int8_attention

TOL = {jnp.float32: (1e-5, 2e-3), jnp.bfloat16: (1e-3, 2.0**-7)}
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
DTYPES = [pytest.param(jnp.float32, id="fp32"), pytest.param(jnp.bfloat16, id="bf16")]
MODES = [pytest.param(True, id="pv_int8"), pytest.param(False, id="qk")]


def _inputs(B, N, H, D, dtype, seed):
    """q, k, v (B, N, H, D) as JAX arrays in ``dtype`` and as torch tensors
    of the same values, and their per-head amax (H,) as a calibration gives
    them, shrunk by 10% so that some values clip at ±127."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal((B, N, H, D)).astype(np.float32), dtype) for _ in range(3)]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(TORCH_DTYPE[dtype]) for x in jx]
    amax = [0.9 * np.abs(np.asarray(x, np.float32)).max(axis=(0, 1, 3)) for x in jx]
    return jx, tx, [a.astype(np.float32) for a in amax]


def _compare(got, want, dtype):
    close(got.float(), np.asarray(want.astype(jnp.float32)), *TOL[dtype])


@pytest.mark.parametrize("pv_int8", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [16, 256, 1024])
def test_plain_version_matches_pallas_flash_int8(N, dtype, pv_int8):
    """The flash route at head_dim 72: one scale block of min(1024, N) keys."""
    jx, tx, amax = _inputs(1, N, 2, 72, dtype, seed=N)
    want = jax_flash_int8(*jx, *map(jnp.asarray, amax), dtype, pv_int8=pv_int8)
    got = int8_attention(*tx, *map(torch.from_numpy, amax), tx[0].dtype, pv_int8, flash_scale_block(N))
    _compare(got, want, dtype)


@pytest.mark.parametrize("pv_int8", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_scale_blocks_follow_the_flash_wrapper_past_1024_keys(dtype, pv_int8):
    """N = 2048: two scale blocks of 1024 keys, joined by the online rescale
    (small B·H and head_dim: the rule is what is tested)."""
    assert flash_scale_block(2048) == 1024
    jx, tx, amax = _inputs(1, 2048, 1, 16, dtype, seed=3)
    want = jax_flash_int8(*jx, *map(jnp.asarray, amax), dtype, pv_int8=pv_int8)
    got = int8_attention(*tx, *map(torch.from_numpy, amax), tx[0].dtype, pv_int8, 1024)
    _compare(got, want, dtype)


@pytest.mark.parametrize("pv_int8", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [16, 256])
def test_plain_version_matches_the_fused_int8_core(N, dtype, pv_int8):
    """``scale_block=None``: the fused core the JAX model runs at short N (and
    the JAX flash wrapper falls back to)."""
    jx, tx, amax = _inputs(2, N, 2, 72, dtype, seed=N + 1)
    want = jax_int8_attention(*jx, *map(jnp.asarray, amax), dtype, pv_int8=pv_int8)
    got = int8_attention(*tx, *map(torch.from_numpy, amax), tx[0].dtype, pv_int8, None)
    _compare(got, want, dtype)


def test_flash_scale_block_rule():
    """min(1024, N) keys when N divides by it, else the fused core
    (``attention.py:426-433``)."""
    assert [flash_scale_block(n) for n in (16, 256, 1000, 1024, 2048, 3072)] == [
        16, 256, 1000, 1024, 1024, 1024
    ]
    assert flash_scale_block(1500) is None and flash_scale_block(2500) is None


def test_wrapper_on_cpu_is_the_plain_version_on_strided_views():
    """The model hands over column views of its fused (B, N, 3, H, D) qkv:
    on CPU tensors the wrapper runs the plain version on them, and counts no
    launch."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((2, 32, 3, 2, 24)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    amax = [t.abs().amax(dim=(0, 1, 3)) for t in (q, k, v)]
    before = flash_attention_int8.launches
    for pv_int8 in (True, False):
        for block in (None, 16, 32):
            got = flash_attention_int8(q, k, v, *amax, pv_int8, block)
            want = int8_attention(*(t.contiguous() for t in (q, k, v)), *amax, q.dtype, pv_int8, block)
            assert got.shape == (2, 32, 2, 24) and got.dtype == torch.float32
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert flash_attention_int8.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 8, 2, 16))
    amax = [torch.ones(2)] * 3
    with pytest.raises(TypeError):
        flash_attention_int8(x.half(), x.half(), x.half(), *amax)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 8, 1, 136))
        flash_attention_int8(big, big, big, *[torch.ones(1)] * 3)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 8, 16, 2)).transpose(2, 3)
        flash_attention_int8(t, t, t, *amax)
    with pytest.raises(ValueError, match="amax"):
        flash_attention_int8(x, x, x, torch.ones(3), *amax[:2])
    with pytest.raises(ValueError, match="scale_block"):
        flash_attention_int8(x, x, x, *amax, True, 0)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_int8(x, x[:, :4], x, *amax)
