"""Port parity: the plain versions of the port's three CUDA kernels against the
JAX Pallas kernels they replace, run in interpret mode on the CPU.

On the CPU the wrappers run exactly these plain versions (the kernels
themselves are held against them on the card by ``chip_smoke.py``). All
inputs are fp32 numpy arrays from one seed, matmuls at full fp32
(``allow_tf32`` off, JAX precision "highest" from conftest).

Tolerance: 1e-5 relative (and 1e-6 absolute on O(1) values). Both sides do
the same fp32 arithmetic in a different summation order; over a 72-long
dot and a 256-long softmax sum that moves results by a few ulp (~1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latte_tpu.kernels import adaln as jax_adaln
from latte_tpu.kernels import attention as jax_attn
from latte_tpu_torch.kernels import (
    attention_reference,
    flash_attention,
    ln_modulate,
    ln_modulate_reference,
    residual_ln_modulate,
    residual_ln_modulate_reference,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6


def _qkv(B, N, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, H, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("N", [16, 256, 24])
def test_attention_matches_pallas_flash(N):
    B, H, D = 2, 3, 72
    q, k, v = _qkv(B, N, H, D)
    # the JAX kernel with its default tiling (block = N), in interpret mode,
    # and the lse it writes for its backward
    want, want_lse = jax_attn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), N, N, interpret=True
    )
    got, lse = attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), return_lse=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(want_lse)[..., 0], rtol=RTOL, atol=ATOL
    )
    # and the public entry point the model calls
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
        rtol=RTOL,
        atol=ATOL,
    )


def test_attention_reads_strided_qkv_views():
    """The model hands the wrapper q/k/v column views of its fused qkv."""
    B, N, H, D = 2, 16, 4, 8
    qkv = torch.from_numpy(
        np.random.default_rng(1).standard_normal((B, N, 3, H, D)).astype(np.float32)
    )
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    want = jax_attn.attention_reference(*(jnp.asarray(t.contiguous().numpy()) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _adaln_inputs(B, N, D, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, N, D)) + offset).astype(np.float32)
    delta = rng.standard_normal((B, N, D)).astype(np.float32)
    gate, shift, scale = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(3))
    return x, delta, gate, shift, scale


@pytest.mark.parametrize("shape", [(4, 16, 128), (2, 32, 384)])
def test_ln_modulate_matches_pallas(shape):
    x, _, _, shift, scale = _adaln_inputs(*shape)
    want = jax_adaln.ln_modulate(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale))
    got = ln_modulate_reference(*map(torch.from_numpy, (x, shift, scale)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 16, 128), (2, 32, 384)])
def test_residual_ln_modulate_matches_pallas(shape):
    # a mean offset of 100 is where a one-pass variance would drift by ~3e-3
    x, delta, gate, shift, scale = _adaln_inputs(*shape, offset=100.0)
    want_y, want_out = jax_adaln.residual_ln_modulate(
        *map(jnp.asarray, (x, delta, gate, shift, scale))
    )
    got_y, got_out = residual_ln_modulate_reference(
        *map(torch.from_numpy, (x, delta, gate, shift, scale))
    )
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    # LN divides by the row's std (~1 here) after subtracting mu ~ 100, so
    # the fp32 rounding of y (6e-6 at 100) sets the absolute floor
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=RTOL, atol=5e-5)


def test_wrappers_take_the_plain_version_on_cpu():
    x, delta, gate, shift, scale = map(torch.from_numpy, _adaln_inputs(2, 8, 64))
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 2, 16))
    counts = (flash_attention.launches, ln_modulate.launches, residual_ln_modulate.launches)
    assert torch.equal(flash_attention(q, k, v), attention_reference(q, k, v))
    assert torch.equal(ln_modulate(x, shift, scale), ln_modulate_reference(x, shift, scale))
    for a, b in zip(
        residual_ln_modulate(x, delta, gate, shift, scale),
        residual_ln_modulate_reference(x, delta, gate, shift, scale),
    ):
        assert torch.equal(a, b)
    # a CPU call launches nothing, so no count moves
    assert counts == (
        flash_attention.launches, ln_modulate.launches, residual_ln_modulate.launches
    )


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 2, 16))
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :4], v)
    with pytest.raises(ValueError):
        big = torch.zeros(1, 4, 1, 160)
        flash_attention(big, big, big)
    x, delta, gate, shift, scale = map(torch.from_numpy, _adaln_inputs(2, 8, 64))
    with pytest.raises(ValueError):
        ln_modulate(x, shift[:1], scale)
    with pytest.raises(TypeError):
        residual_ln_modulate(x, delta.double(), gate, shift, scale)
    # the kernels' layout rules hold on the CPU too, so CPU runs rehearse them
    with pytest.raises(ValueError, match="contiguous"):
        ln_modulate(x.transpose(0, 1).contiguous().transpose(0, 1), shift, scale)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(-1, -2).contiguous().transpose(-1, -2), k, v)


def test_bf16_plain_versions_track_pallas_bf16():
    """The plain versions round to bf16 where the TPU kernels do: y within one
    bf16 rounding step (2^-8 relative), the outputs within two (2^-7) on O(1)
    values, since the two sides sum in another order before rounding."""
    x, delta, gate, shift, scale = _adaln_inputs(2, 16, 256, seed=3)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    jbf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want_y, want_out = jax_adaln.residual_ln_modulate(*map(jbf, (x, delta, gate, shift, scale)))
    got_y, got_out = residual_ln_modulate_reference(*map(bf, (x, delta, gate, shift, scale)))
    np.testing.assert_allclose(got_y.float().numpy(), np.asarray(want_y, np.float32), rtol=2**-8, atol=2**-8)
    np.testing.assert_allclose(
        got_out.float().numpy(), np.asarray(want_out, np.float32), rtol=2**-7, atol=2**-7
    )
    q, k, v = _qkv(2, 16, 2, 72, seed=4)
    want = jax_attn.flash_attention(jbf(q), jbf(k), jbf(v))
    got = attention_reference(bf(q), bf(k), bf(v))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=2**-7
    )


def test_kernel_library_is_keyed_by_its_sources():
    from latte_tpu_torch.kernels import build

    names = {p.name for p in build.sources()}
    assert names == {
        "adaln.cu", "flash_attention.cu", "flash_attention_bwd.cu", "flash_attention_bwd_f32.cu",
        "flash_attention_bwd_tc.cu", "flash_attention_f32.cu", "flash_attention_int8.cu",
        "flash_attention_int8_tc.cu", "flash_attention_tc.cu",
    }
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.name.startswith("liblatte_kernels_")
    assert path == build.library_path()  # stable for an unchanged tree
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    # every C entry point the wrappers call is declared for ctypes
    src = "".join(p.read_text() for p in build.sources())
    for name, argtypes in build._SIGNATURES.items():
        decl = src[src.index(f'extern "C" int {name}('):]
        assert decl[: decl.index(")")].count(",") + 1 == len(argtypes), name
