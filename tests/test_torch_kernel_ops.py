"""The serving path's kernels as ``torch.library`` custom ops
(``latte_tpu_torch/kernels/ops.py``): ``opcheck`` on each at tiny shapes in
bf16 and fp32 (schema, fake registration against the real one, autograd
registration, AOT dispatch), each op's CPU registration equal to the plain
version to the bit, and the backward through the wrappers' autograd
functions unchanged (equal to the plain backward to the bit)."""

import numpy as np
import pytest
import torch

from latte_tpu_torch.kernels import adaln, attention, attention_int8, ops
from torch_port_util import one_cpu_thread

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_cpu_thread():
        yield


def _qkv(dtype, seed=0, B=2, N=8, H=2, D=8):
    """q, k, v as the model passes them: strided views of one (B, N, 3, H, D)
    projection."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3, H, D)).astype(np.float32)).to(dtype)
    return qkv.unbind(2)


def _adaln(dtype, seed=1, B=2, N=4, D=16):
    """x, delta (B, N, D) and shift/scale/gate as column chunks of one (B, 6D)
    modulation, as the block passes them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)  # noqa: E731
    mod = f(B, 6 * D).chunk(6, dim=-1)
    return f(B, N, D), f(B, N, D), mod[2], mod[0], mod[1]


def _amax(q, k, v):
    return [t.float().abs().amax(dim=(0, 1, 3)) for t in (q, k, v)]


def _cases(dtype):
    q, k, v = _qkv(dtype)
    x, delta, gate, shift, scale = _adaln(dtype)
    return {
        "flash_attention": (ops.flash_attention, (q, k, v, True)),
        "flash_attention_no_lse": (ops.flash_attention, (q, k, v, False)),
        "ln_modulate": (ops.ln_modulate, (x, shift, scale)),
        "residual_ln_modulate": (ops.residual_ln_modulate, (x, delta, gate, shift, scale)),
        "flash_attention_int8": (ops.flash_attention_int8, (q, k, v, *_amax(q, k, v), True, None)),
        "flash_attention_int8_qk_block": (ops.flash_attention_int8, (q, k, v, *_amax(q, k, v), False, 4)),
    }


CASES = list(_cases(torch.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_opcheck(case, dtype):
    op, args = _cases(DTYPES[dtype])[case]
    torch.library.opcheck(op, args)


def _plain(case, args):
    """The plain version each op's CPU registration must equal."""
    if case.startswith("flash_attention_int8"):
        q, k, v, qa, ka, va, pv_int8, block = args
        return attention_int8.int8_attention(q, k, v, qa, ka, va, q.dtype, pv_int8, block)
    if case.startswith("flash_attention"):
        q, k, v, return_lse = args
        return attention.attention_reference(q, k, v, return_lse=True) if return_lse else attention.attention_reference(q, k, v)
    if case == "ln_modulate":
        return adaln.ln_modulate_reference(*args)
    return adaln.residual_ln_modulate_reference(*args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_cpu_registration_is_the_plain_version(case, dtype):
    op, args = _cases(DTYPES[dtype])[case]
    got, want = op(*args), _plain(case, args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if case == "flash_attention_no_lse":
        assert got[1].shape == (0,) and got[1].dtype == torch.float32
        got = got[:1]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wrappers_call_the_ops_and_count_no_cpu_launch(dtype):
    """The wrappers go through the ops (the dispatcher sees them) and, on the
    CPU, count no launch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Seen(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    q, k, v = _qkv(DTYPES[dtype])
    x, delta, gate, shift, scale = _adaln(DTYPES[dtype])
    before = (attention.flash_attention.launches, adaln.ln_modulate.launches,
              adaln.residual_ln_modulate.launches, attention_int8.flash_attention_int8.launches)
    with Seen():
        attention.flash_attention(q, k, v)
        adaln.ln_modulate(x, shift, scale)
        adaln.residual_ln_modulate(x, delta, gate, shift, scale)
        attention_int8.flash_attention_int8(q, k, v, *_amax(q, k, v))
    for name in ops.OPS:
        assert name.replace("::", ".") + ".default" in seen, name
    assert before == (attention.flash_attention.launches, adaln.ln_modulate.launches,
                      adaln.residual_ln_modulate.launches, attention_int8.flash_attention_int8.launches)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_backward_through_the_autograd_functions_unchanged(dtype):
    """flash_attention and attention_qkv differentiate as before: their
    gradients equal the plain backward's to the bit."""
    q, k, v = (t.clone().requires_grad_(True) for t in _qkv(DTYPES[dtype]))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)).to(q.dtype)
    out, lse = attention.flash_attention(q, k, v, return_lse=True)
    out.backward(g)
    want = attention.attention_backward_reference(q.detach(), k.detach(), v.detach(), out.detach(), lse, g)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    qkv = torch.stack([t.detach() for t in (q, k, v)], dim=2).requires_grad_(True)
    attention.attention_qkv(qkv).backward(g)
    for i, w in enumerate(want):
        torch.testing.assert_close(qkv.grad[:, :, i], w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_adaln_backward_through_the_autograd_functions_unchanged(dtype):
    x, delta, gate, shift, scale = (t.clone().requires_grad_(True) for t in _adaln(DTYPES[dtype]))
    rng = np.random.default_rng(6)
    g1, g2 = (torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(x.dtype) for _ in range(2))
    adaln.ln_modulate(x, shift, scale).backward(g1)
    dx, dshift, dscale = adaln._ln_mod_backward(x.detach(), scale.detach(), g1)
    for got, w in zip((x.grad, shift.grad, scale.grad), (dx, dshift, dscale)):
        torch.testing.assert_close(got, w.to(got.dtype), rtol=0, atol=0)
    for t in (x, shift, scale):
        t.grad = None
    y, out = adaln.residual_ln_modulate(x, delta, gate, shift, scale)
    torch.autograd.backward((y, out), (g2, g1))
    yd = y.detach()
    dy, dshift, dscale = adaln._ln_mod_backward(yd, scale.detach(), g1)
    dy = dy + g2.float()
    want = (dy, dy * gate.detach().float()[:, None, :], (dy * delta.detach().float()).sum(dim=1), dshift, dscale)
    for got, w in zip((x.grad, delta.grad, gate.grad, shift.grad, scale.grad), want):
        torch.testing.assert_close(got, w.to(got.dtype), rtol=0, atol=0)
