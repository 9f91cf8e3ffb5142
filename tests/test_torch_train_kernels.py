"""Port parity for the backward passes of the kernels: the flash-attention
backward (the plain version of the dQ and dK/dV CUDA kernels, and the
autograd of the port's attention) against ``jax.vjp`` of the Pallas
``flash_attention(..., bwd_impl="pallas")`` in interpret mode, and the adaLN
backward against ``jax.vjp`` of the JAX ``ln_modulate`` /
``residual_ln_modulate``.

On the CPU the wrappers run exactly these plain versions; the CUDA kernels
are held against them on the card by ``chip_smoke.py``. Inputs are numpy
arrays from one seed; matmuls run at full fp32 on both sides.

Tolerances: fp32, 1e-5 relative L2 (and no element off by more than 1e-5 of
the largest magnitude): the same fp32 arithmetic, summed in another order.
bf16: one rounding step, 2^-7 of the largest magnitude per element (and
2^-7 relative): both sides round at the same points, but a sum that lands
near a rounding boundary may round either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latte_tpu.kernels import adaln as jax_adaln
from latte_tpu.kernels import attention as jax_attn
from latte_tpu_torch.kernels import (
    attention_qkv,
    attention_backward_reference,
    attention_delta,
    attention_reference,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    ln_modulate,
    residual_ln_modulate,
)

torch.backends.cuda.matmul.allow_tf32 = False

FP32_REL = 1e-5
BF16_STEP = 2.0**-7


def _close(got, want, dtype):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    if dtype == torch.float32:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= FP32_REL, f"relative L2 error {err:.3g} > {FP32_REL}"
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_REL * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=BF16_STEP * scale)


def _as(a, dtype):
    """numpy fp32 -> (torch, jax) arrays of one dtype with identical values."""
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _jax_vjp(q, k, v, dout):
    out, vjp = jax.vjp(lambda a, b, c: jax_attn.flash_attention(a, b, c, bwd_impl="pallas"), q, k, v)
    return out, vjp(dout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [72, 32])
@pytest.mark.parametrize("N", [16, 32])
def test_flash_backward_matches_pallas(N, D, dtype):
    B, H = 2, 3
    rng = np.random.default_rng(N + D)
    (q, jq), (k, jk), (v, jv), (g, jg) = (
        _as(rng.standard_normal((B, N, H, D)).astype(np.float32), dtype) for _ in range(4)
    )
    _, want = _jax_vjp(jq, jk, jv, jg)
    # the plain backward, from the plain forward's output and logsumexp
    out, lse = attention_reference(q, k, v, return_lse=True)
    for got, w in zip(attention_backward_reference(q, k, v, out, lse, g), want):
        assert got.dtype == dtype
        _close(got.float(), np.asarray(w, np.float32), dtype)
    # the autograd of the port's differentiable flash_attention
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves), leaves, g)
    for a, w in zip(got, want):
        _close(a.float(), np.asarray(w, np.float32), dtype)


def test_fused_qkv_backward_with_noncontiguous_dout():
    """The model's call: q, k, v are views of one (B, N, 3, H, D) projection,
    whose gradient comes back as one tensor; the upstream gradient is a
    transposed (non-contiguous) tensor here, and an expanded one (zero
    strides, as after ``.sum()``) below."""
    B, N, H, D = 2, 16, 2, 72
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3, H, D)).astype(np.float32))
    g_t = torch.from_numpy(rng.standard_normal((B, N, D, H)).astype(np.float32)).transpose(2, 3)
    assert not g_t.is_contiguous()
    _, want = _jax_vjp(*(jnp.asarray(t.contiguous().numpy()) for t in qkv.unbind(2)),
                       jnp.asarray(g_t.contiguous().numpy()))
    leaf = qkv.clone().requires_grad_()
    (dqkv,) = torch.autograd.grad(attention_qkv(leaf), leaf, g_t)
    assert dqkv.shape == qkv.shape and dqkv.is_contiguous()
    for a, w in zip(dqkv.unbind(2), want):
        _close(a, w, torch.float32)
    # the plain path (plain=True) gives the same gradient
    (plain,) = torch.autograd.grad(attention_qkv(leaf, plain=True), leaf, g_t)
    _close(plain, dqkv.numpy(), torch.float32)
    # expanded dout: gradient of out.sum()
    (dsum,) = torch.autograd.grad(attention_qkv(leaf).sum(), leaf)
    _, want = _jax_vjp(*(jnp.asarray(t.contiguous().numpy()) for t in qkv.unbind(2)),
                       jnp.ones((B, N, H, D), jnp.float32))
    for a, w in zip(dsum.unbind(2), want):
        _close(a, w, torch.float32)


def test_backward_wrappers_write_into_strided_views():
    """The dQ and dK/dV wrappers fill the column views of one fused gradient
    buffer, read strided q/k/v and an expanded dout; on the CPU they run
    their plain halves and launch nothing."""
    B, N, H, D = 1, 16, 2, 8
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3, H, D)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    # expanded along the tokens (stride 0): readable through its strides
    dout = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(np.float32)).expand(B, N, H, D)
    out, lse = attention_reference(q, k, v, return_lse=True)
    delta = attention_delta(out, dout)
    buf = torch.full((B, N, 3, H, D), float("nan"))
    counts = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    flash_attention_bwd_dq(q, k, v, dout, lse, delta, buf[:, :, 0])
    flash_attention_bwd_dkv(q, k, v, dout, lse, delta, buf[:, :, 1], buf[:, :, 2])
    assert counts == (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    want = attention_backward_reference(q, k, v, out, lse, dout.contiguous())
    for got, w in zip(buf.unbind(2), want):
        assert torch.equal(got, w)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd_dq(q, k, v, dout, lse, delta, torch.empty(B, N, D, H).transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):  # expanded along head_dim: not readable
        flash_attention_bwd_dq(q, k, v, torch.ones(1, 1, 1, 1).expand(B, N, H, D), lse, delta,
                               buf[:, :, 0])
    with pytest.raises(ValueError, match="fp32"):
        flash_attention_bwd_dq(q, k, v, dout, lse.double(), delta, buf[:, :, 0])


def _adaln_inputs(B, N, D, seed):
    rng = np.random.default_rng(seed)
    x, delta, g_y, g_out = (rng.standard_normal((B, N, D)).astype(np.float32) for _ in range(4))
    mod = rng.standard_normal((B, 6 * D)).astype(np.float32)
    return x, delta, mod, g_y, g_out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_ln_modulate_backward_matches_jax(dtype):
    """shift/scale are column chunks of one modulation output, as in the
    model; their gradients reach it through the chunk."""
    B, N, D = 2, 16, 128
    x, _, mod, _, g_out = _adaln_inputs(B, N, D, seed=11)
    (tx, jx), (tm, jm), (tg, jg) = (_as(a, dtype) for a in (x, mod, g_out))
    _, vjp = jax.vjp(lambda a, s, c: jax_adaln.ln_modulate(a, s, c), jx, jm[:, :D], jm[:, D:2 * D])
    want = vjp(jg)
    leaves = [tx.clone().requires_grad_(), tm.clone().requires_grad_()]
    shift, scale = leaves[1][:, :D], leaves[1][:, D:2 * D]
    dx, dmod = torch.autograd.grad(ln_modulate(leaves[0], shift, scale), leaves, tg)
    assert dx.dtype == dtype and dmod.dtype == dtype
    _close(dx.float(), np.asarray(want[0], np.float32), dtype)
    _close(dmod[:, :D].float(), np.asarray(want[1], np.float32), dtype)
    _close(dmod[:, D:2 * D].float(), np.asarray(want[2], np.float32), dtype)
    assert not dmod[:, 2 * D:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_residual_ln_modulate_backward_matches_jax(dtype):
    B, N, D = 2, 16, 128
    x, delta, mod, g_y, g_out = _adaln_inputs(B, N, D, seed=12)
    (tx, jx), (td, jd), (tm, jm), (tgy, jgy), (tgo, jgo) = (
        _as(a, dtype) for a in (x, delta, mod, g_y, g_out)
    )
    chunks = lambda m: (m[:, 2 * D:3 * D], m[:, 3 * D:4 * D], m[:, 4 * D:5 * D])  # noqa: E731
    _, vjp = jax.vjp(
        lambda a, b, gate, s, c: jax_adaln.residual_ln_modulate(a, b, gate, s, c),
        jx, jd, *chunks(jm),
    )
    want = vjp((jgy, jgo))
    leaves = [t.clone().requires_grad_() for t in (tx, td, tm)]
    y, out = residual_ln_modulate(leaves[0], leaves[1], *chunks(leaves[2]))
    dx, ddelta, dmod = torch.autograd.grad((y, out), leaves, (tgy, tgo))
    for got, w in zip((dx, ddelta, *chunks(dmod)), want):
        assert got.dtype == dtype
        _close(got.float(), np.asarray(w, np.float32), dtype)
