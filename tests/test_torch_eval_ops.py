"""The port's host ops of the metric tools against the JAX package's: the
XLA ops ``upfirdn2d`` and its helpers, ``bias_act``, ``conv2d_resample``,
``gradfix`` (``conv2d`` and its transpose, ``no_weight_gradients``,
``grid_sample`` to second order, ``fma``), and the detectors' bilinear
resize against ``jax.image.resize``. fp32 on the CPU, inputs from numpy
seeds; each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latte_tpu.kernels import bias_act as jbias_act
from latte_tpu.kernels import conv2d_resample as jresample
from latte_tpu.kernels import gradfix as jgradfix
from latte_tpu.kernels import upfirdn as jupfirdn
from latte_tpu_torch.eval.i3d import resize_bilinear
from latte_tpu_torch.kernels import bias_act, conv2d_resample, gradfix, upfirdn

# fp32 results of the same sums in another order (XLA against torch)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("up,down,pad,flip,gain", [
    (1, 1, 0, False, 1.0), (2, 1, (2, 1, 2, 1), False, 4.0), (1, 2, 1, True, 1.0),
    ((2, 1), (1, 2), (1, 2, -1, 0), False, 2.0), (3, 2, (3, 2), True, 1.0),
])
def test_upfirdn2d_matches_jax(up, down, pad, flip, gain):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    f = rng.standard_normal((4, 3)).astype(np.float32)
    want = jupfirdn.upfirdn2d(jnp.asarray(x), jnp.asarray(f), up=up, down=down, padding=pad, flip_filter=flip, gain=gain)
    got = upfirdn.upfirdn2d(_t(x), _t(f), up=up, down=down, padding=pad, flip_filter=flip, gain=gain)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("helper", ["filter2d", "upsample2d", "downsample2d"])
@pytest.mark.parametrize("taps", [[1, 3, 3, 1], [1, 2, 1]])
def test_fir_helpers_and_setup_filter_match_jax(helper, taps):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 2, 8, 10)).astype(np.float32)
    for kw in (dict(normalize=True), dict(normalize=False, flip_filter=True, gain=2.0)):
        fj, ft = jupfirdn.setup_filter(taps, **kw), upfirdn.setup_filter(taps, **kw)
        np.testing.assert_array_equal(_np(ft), np.asarray(fj))
    want = getattr(jupfirdn, helper)(jnp.asarray(x), fj, padding=1, gain=1.5)
    got = getattr(upfirdn, helper)(_t(x), ft, padding=1, gain=1.5)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # 1D taps straight into the helper (the reference's separable form)
    one_d = np.asarray(taps, np.float32) / np.sum(taps)
    np.testing.assert_allclose(_np(getattr(upfirdn, helper)(_t(x), _t(one_d))),
                               np.asarray(getattr(jupfirdn, helper)(jnp.asarray(x), jnp.asarray(one_d))), **TOL)


@pytest.mark.parametrize("act", sorted(jbias_act.activation_funcs))
def test_bias_act_matches_jax(act):
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 5, 4, 3))).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    for kw in (dict(), dict(gain=0.7, clamp=1.5), dict(alpha=0.1, clamp=0.5)):
        want = jbias_act.bias_act(jnp.asarray(x), jnp.asarray(b), dim=1, act=act, **kw)
        got = bias_act.bias_act(_t(x), _t(b), dim=1, act=act, **kw)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the bias on another axis, and none
    b3 = rng.standard_normal(3).astype(np.float32)
    np.testing.assert_allclose(_np(bias_act.bias_act(_t(x), _t(b3), dim=3, act=act)),
                               np.asarray(jbias_act.bias_act(jnp.asarray(x), jnp.asarray(b3), dim=3, act=act)), **TOL)
    np.testing.assert_allclose(_np(bias_act.bias_act(_t(x), act=act)),
                               np.asarray(jbias_act.bias_act(jnp.asarray(x), act=act)), **TOL)


@pytest.mark.parametrize("up,down,pad", [(2, 1, 1), (1, 2, 1), (2, 2, 0), (1, 1, 1)])
@pytest.mark.parametrize("flip_weight", [True, False])
def test_conv2d_resample_matches_jax(up, down, pad, flip_weight):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    f = np.asarray(jupfirdn.setup_filter([1, 3, 3, 1]))
    want = jresample.conv2d_resample(jnp.asarray(x), jnp.asarray(w), jnp.asarray(f), up=up, down=down, padding=pad,
                                     flip_weight=flip_weight)
    got = conv2d_resample.conv2d_resample(_t(x), _t(w), _t(f), up=up, down=down, padding=pad, flip_weight=flip_weight)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _conv_loss_jax(x, w, **kw):
    return jnp.sum(jnp.sin(jgradfix.conv2d(x, w, **kw)))


@pytest.mark.parametrize("kw", [dict(stride=2, padding=1), dict(padding=2, dilation=2, groups=2),
                                dict(stride=2, padding=1, transpose=True, output_padding=1)])
def test_gradfix_conv2d_and_its_gradients_match_jax(kw):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 7, 7)).astype(np.float32)
    w = rng.standard_normal((4 if kw.get("transpose") else 6, 6 // kw.get("groups", 1) if kw.get("transpose") else
                             4 // kw.get("groups", 1), 3, 3)).astype(np.float32)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    np.testing.assert_allclose(_np(gradfix.conv2d(_t(x), _t(w), **kw)), np.asarray(jgradfix.conv2d(jx, jw, **kw)), **TOL)
    gx_j, gw_j = jax.grad(lambda a, b: _conv_loss_jax(a, b, **kw), argnums=(0, 1))(jx, jw)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    torch.sin(gradfix.conv2d(tx, tw, **kw)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(gx_j), **TOL)
    np.testing.assert_allclose(_np(tw.grad), np.asarray(gw_j), **TOL)
    # no_weight_gradients: the weights get none, the input the same
    with jgradfix.no_weight_gradients():
        gw0 = jax.grad(lambda b: _conv_loss_jax(jx, b, **kw))(jw)
    assert not np.any(np.asarray(gw0))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    with gradfix.no_weight_gradients():
        torch.sin(gradfix.conv2d(tx, tw, **kw)).sum().backward()
    assert tw.grad is None and not gradfix._weight_gradients_disabled
    np.testing.assert_allclose(_np(tx.grad), np.asarray(gx_j), **TOL)


def test_grid_sample_matches_jax_to_second_order():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 6, 7)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 4, 5, 2)).astype(np.float32)  # some points outside
    v = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    jx, jg, jv = map(jnp.asarray, (x, grid, v))
    np.testing.assert_allclose(_np(gradfix.grid_sample(_t(x), _t(grid))), np.asarray(jgradfix.grid_sample(jx, jg)),
                               **TOL)
    # torch's own grid_sample on the forward (zeros, bilinear, align_corners=False)
    np.testing.assert_allclose(_np(gradfix.grid_sample(_t(x), _t(grid))),
                               _np(torch.nn.functional.grid_sample(_t(x), _t(grid), align_corners=False)), **TOL)

    def second_jax(a, g):
        dg = jax.grad(lambda gg: jnp.sum(jgradfix.grid_sample(a, gg) * jv))(g)
        return jnp.sum(dg**2)

    want_x, want_g = jax.grad(second_jax, argnums=(0, 1))(jx, jg)
    tx, tg = _t(x).requires_grad_(), _t(grid).requires_grad_()
    (dg,) = torch.autograd.grad((gradfix.grid_sample(tx, tg) * _t(v)).sum(), tg, create_graph=True)
    got_x, got_g = torch.autograd.grad(dg.pow(2).sum(), (tx, tg))
    assert np.abs(np.asarray(want_g)).max() > 0
    np.testing.assert_allclose(_np(got_x), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(_np(got_g), np.asarray(want_g), **TOL)


def test_fma_matches_jax_and_unbroadcasts():
    rng = np.random.default_rng(6)
    a, b, c = (rng.standard_normal(s).astype(np.float32) for s in ((2, 3), (3,), (2, 1)))
    np.testing.assert_allclose(_np(gradfix.fma(_t(a), _t(b), _t(c))),
                               np.asarray(jgradfix.fma(*map(jnp.asarray, (a, b, c)))), **TOL)
    tb, tc = _t(b).requires_grad_(), _t(c).requires_grad_()
    gradfix.fma(_t(a), tb, tc).sum().backward()
    assert tb.grad.shape == (3,) and tc.grad.shape == (2, 1)


@pytest.mark.parametrize("src,dst", [((256, 256), (224, 224)), ((256, 256), (112, 112)), ((256, 256), (299, 299)),
                                     ((64, 64), (224, 224)), ((48, 64), (56, 40)), ((48, 64), (48, 40))])
def test_resize_matches_jax_image_resize(src, dst):
    """The detectors' resize against ``jax.image.resize(..., "bilinear")``
    (antialiased where an axis shrinks) within 1e-4 on a 0-255 scale: the
    four sizes of the detectors, an image that shrinks along one axis while
    it grows along the other, and one whose height stays."""
    x = np.random.default_rng(7).uniform(0, 255, (2, 3, *src)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3, *dst), method="bilinear")
    got = resize_bilinear(_t(x), dst)
    assert got.shape == want.shape
    assert np.abs(_np(got) - np.asarray(want)).max() <= 1e-4
