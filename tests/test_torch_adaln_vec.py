"""The adaLN kernels' routes and plain versions, on the CPU.

``adaln_route`` picks the vector kernels of ``csrc/adaln.cu`` (a warp holds
a row in registers, 8- or 16-byte accesses) for the registry's widths on
aligned layouts, and the first, generic kernels for everything else. It
reads only shapes, strides and addresses, so it is checked here on CPU
tensors laid out as the model hands them over: x contiguous, shift, scale
and gate column chunks of one (B, 6·D) modulation output
(``latte_tpu_torch/models/layers.py:282-284``). The kernels themselves are
held against the plain versions on the card by ``chip_smoke.py``; here the
plain versions are held against the Pallas kernels they replace (interpret
mode), at the widths the vector kernels are built for.

Tolerances. fp32: 1e-5 relative and 1e-6 absolute, as in
``test_torch_kernels.py`` (the same arithmetic summed in another order, a
few ulp apart). At a mean offset of 100 the absolute floor is
5e-5·(1 + |scale|): each side's fp32 mean of D values near 100 (partial
sums up to 1e5) is off the exact mean by up to ~1.7e-5 (measured against
fp64 over 10 seeds at D = 768 and 1152), LN divides that by a std of ~1,
and the modulation multiplies it by 1 + scale. bf16: y to the bit (one
elementwise fp32 sum rounded once on both sides); out equal to the bit on all but 1% of the
elements and the rest within one bf16 step, 2^-7 of the largest magnitude:
the statistics are fp32 sums in another order, which can move an output
across a bf16 rounding boundary (0-0.02% of the elements at these shapes).
These are the limits ``chip_smoke.py`` holds the bf16 kernels to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latte_tpu.kernels import adaln as jax_adaln
from latte_tpu_torch.kernels import adaln, build
from latte_tpu_torch.kernels.adaln import (
    adaln_route,
    ln_modulate,
    ln_modulate_reference,
    residual_ln_modulate,
    residual_ln_modulate_reference,
)

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
SHARE_APART = 0.01  # chip_smoke.py's TILED_SHARE_APART


def _model_layout(B, N, D, dtype, x_offset=0, extra_cols=0):
    """x and delta (B, N, D), contiguous, ``x_offset`` elements into their
    storage; shift, scale, gate the first three column chunks of one
    (B, 6·D + extra_cols) modulation output, as the model chunks it."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(x_offset + B * N * D, generator=gen).to(dtype)[x_offset:].view(B, N, D)
    delta = torch.randn(B, N, D, generator=gen).to(dtype)
    mod = torch.randn(B, 6 * D + extra_cols, generator=gen).to(dtype)
    shift, scale, gate = mod[:, :D], mod[:, D:2 * D], mod[:, 2 * D:3 * D]
    return x, delta, gate, shift, scale


def _routes(x, delta, gate, shift, scale):
    return adaln_route(x, (), (shift, scale)), adaln_route(x, (delta,), (gate, shift, scale))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", adaln.VEC_DIMS)
def test_route_takes_the_registry_widths(D, dtype):
    ops = _model_layout(2, 16, D, DTYPES[dtype])
    assert ops[3].stride(0) == 6 * D and not ops[3].is_contiguous()
    assert _routes(*ops) == ("vector", "vector")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "case", ["D=1000", "x one element off", "vec_stride off the vector width"]
)
def test_route_sends_the_rest_to_the_generic_kernels(case, dtype):
    kw = {
        "D=1000": dict(D=1000),
        "x one element off": dict(D=1152, x_offset=1),
        "vec_stride off the vector width": dict(D=1152, extra_cols=1),
    }[case]
    D = kw.pop("D")
    ops = _model_layout(2, 16, D, DTYPES[dtype], **kw)
    assert _routes(*ops) == ("generic", "generic")


def test_route_misaligned_delta_or_gate_is_generic():
    x, delta, gate, shift, scale = _model_layout(2, 16, 768, torch.bfloat16)
    off = torch.empty(delta.numel() + 1, dtype=delta.dtype)[1:].view(delta.shape)
    assert adaln_route(x, (off,), (gate, shift, scale)) == "generic"
    wide = torch.zeros(2, 6 * 768 + 4, dtype=x.dtype)
    g, s, c = (wide[:, 1 + i * 768:1 + (i + 1) * 768] for i in range(3))  # 2 bytes off
    assert wide.stride(0) % adaln.VEC_WIDTH == 0
    assert adaln_route(x, (delta,), (g, s, c)) == "generic"


@pytest.mark.parametrize(
    "case", ["D above MAX_DIM", "delta not contiguous", "vector strides differ"]
)
def test_route_raises_on_what_no_kernel_takes(case):
    if case == "D above MAX_DIM":
        x, delta, gate, shift, scale = _model_layout(1, 4, 2048, torch.float32)
    else:
        x, delta, gate, shift, scale = _model_layout(2, 16, 384, torch.float32)
    if case == "delta not contiguous":
        delta = delta.transpose(0, 1).contiguous().transpose(0, 1)
    if case == "vector strides differ":
        gate = gate.contiguous()
    with pytest.raises(ValueError):
        adaln_route(x, (delta,), (gate, shift, scale))


def test_cpu_calls_launch_nothing():
    x, delta, gate, shift, scale = _model_layout(2, 16, 1152, torch.bfloat16)
    before = [getattr(f, a) for f in (ln_modulate, residual_ln_modulate)
              for a in ("launches", "vec_launches")]
    assert torch.equal(ln_modulate(x, shift, scale), ln_modulate_reference(x, shift, scale))
    for a, b in zip(residual_ln_modulate(x, delta, gate, shift, scale),
                    residual_ln_modulate_reference(x, delta, gate, shift, scale)):
        assert torch.equal(a, b)
    assert before == [getattr(f, a) for f in (ln_modulate, residual_ln_modulate)
                      for a in ("launches", "vec_launches")]


def test_vector_entry_points_take_the_generic_arguments():
    for name in ("latte_ln_modulate", "latte_residual_ln_modulate"):
        assert build._SIGNATURES[f"{name}_vec"] == build._SIGNATURES[name]


def _numpy_inputs(D, offset, seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 16, D)) + offset).astype(np.float32)
    delta = rng.standard_normal((2, 16, D)).astype(np.float32)
    mod = rng.standard_normal((2, 6 * D)).astype(np.float32)
    return x, delta, mod[:, 2 * D:3 * D], mod[:, :D], mod[:, D:2 * D]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _assert_fp32_close(got, want, scale, offset):
    got, want = got.numpy(), np.asarray(want)
    floor = 5e-5 * (1.0 + np.abs(scale))[:, None, :] if offset else 1e-6
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + floor), np.abs(got - want).max()


def _assert_bf16_close(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= SHARE_APART, (diff > 0).mean()
    assert diff.max() <= 2.0**-7 * np.abs(want).max(), diff.max()


@pytest.mark.parametrize("mode", ["fp32", "fp32 offset 100", "bf16"])
@pytest.mark.parametrize("D", [1152, 768])
def test_plain_ln_modulate_matches_pallas(D, mode):
    x, _, _, shift, scale = _numpy_inputs(D, 100.0 if "offset" in mode else 0.0)
    if mode == "bf16":
        want = jax_adaln.ln_modulate(*(jnp.asarray(a, jnp.bfloat16) for a in (x, shift, scale)))
        got = ln_modulate_reference(*(_bf16(a) for a in (x, shift, scale)))
        _assert_bf16_close(got, want)
        return
    want = jax_adaln.ln_modulate(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale))
    got = ln_modulate_reference(*map(torch.from_numpy, (x, shift, scale)))
    _assert_fp32_close(got, want, scale, "offset" in mode)


@pytest.mark.parametrize("mode", ["fp32", "fp32 offset 100", "bf16"])
@pytest.mark.parametrize("D", [1152, 768])
def test_plain_residual_ln_modulate_matches_pallas(D, mode):
    ops = _numpy_inputs(D, 100.0 if "offset" in mode else 0.0)
    if mode == "bf16":
        want_y, want = jax_adaln.residual_ln_modulate(*(jnp.asarray(a, jnp.bfloat16) for a in ops))
        got_y, got = residual_ln_modulate_reference(*map(_bf16, ops))
        np.testing.assert_array_equal(got_y.float().numpy(), np.asarray(want_y, np.float32))
        _assert_bf16_close(got, want)
        return
    want_y, want = jax_adaln.residual_ln_modulate(*map(jnp.asarray, ops))
    got_y, got = residual_ln_modulate_reference(*map(torch.from_numpy, ops))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-6)
    _assert_fp32_close(got, want, ops[4], "offset" in mode)
