"""The port's metric detectors (``latte_tpu_torch/eval/{i3d,inception,c3d}.py``)
against the JAX package's Flax detectors, on the CPU in fp32.

Weights are synthetic state dicts from a numpy seed under the reference's
names (pytorch-i3d, torchvision / pytorch-fid, C3D): variance-preserving
conv weights, BatchNorm statistics near 0 and 1. The JAX side loads them
through its ``convert_*_state_dict``, the port through its own, and the
Flax parameters carried back by ``convert.flax_*_to_state_dict`` must equal
the port's conversion. Blocks and the whole C3D are held within 1e-5
relative L2 (the same fp32 sums in another order); the whole-graph I3D and
Inception checks are marked slow, as the JAX package marks its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, one_cpu_thread

from latte_tpu.eval import c3d as jc3d
from latte_tpu.eval import i3d as ji3d
from latte_tpu.eval import inception as jinc
from latte_tpu_torch import convert
from latte_tpu_torch.eval import c3d as tc3d
from latte_tpu_torch.eval import detectors
from latte_tpu_torch.eval import i3d as ti3d
from latte_tpu_torch.eval import inception as tinc

REL = 1e-5  # fp32: the same sums in another order (relative L2)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    with one_cpu_thread():
        yield


def synthetic_sd(model: torch.nn.Module, seed: int, rename=lambda k: k) -> dict:
    """Random weights for ``model``'s keys (renamed by ``rename``) from a
    numpy seed: conv and linear weights N(0, 2/fan_in), BatchNorm scales in
    [0.8, 1.2], biases in [-0.1, 0.1], means in [-0.2, 0.2], variances in
    [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape, leaf = tuple(v.shape), k.rsplit(".", 1)[1]
        if leaf == "running_var":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "running_mean":
            a = rng.uniform(-0.2, 0.2, shape)
        elif leaf == "bias":
            a = rng.uniform(-0.1, 0.1, shape)
        elif len(shape) == 1:  # a BatchNorm's scale
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = rng.standard_normal(shape, dtype=np.float32) * np.sqrt(2.0 / np.prod(shape[1:]))
        sd[rename(k)] = torch.from_numpy(np.asarray(a, np.float32))
    return sd


def _to_jax(x):  # NC... -> N...C
    return jnp.asarray(np.moveaxis(x, 1, -1))


def _from_jax(y):
    return np.moveaxis(np.asarray(y), -1, 1)


def _port(cls, *args, sd):
    m = cls(*args).eval()
    m.load_state_dict(sd, strict=True)
    return m


def _same_as_carried(jax_params, port_sd, fn):
    """``fn`` (a ``convert.flax_*_to_state_dict``) carries the JAX params
    onto the port's conversion of the same reference state dict, bit for bit."""
    carried = {k: v for k, v in fn(jax_params).items() if k in port_sd}
    assert set(carried) == set(port_sd)
    for k, v in port_sd.items():
        assert torch.equal(carried[k], v), k


@pytest.mark.parametrize("shape", [(1, 3, 7, 9, 10), (2, 3, 8, 10, 11)])
@pytest.mark.parametrize("kernel,strides", [((7, 7, 7), (2, 2, 2)), ((3, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 2, 2))])
def test_unit3d_tf_same_matches_flax(shape, kernel, strides):
    """Stride 2 on odd and even sizes pads high by one more (TF-SAME)."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    port = ti3d.Unit3D(3, 8, kernel, strides).eval()
    sd = synthetic_sd(port, 1, lambda k: "u." + k)
    params = ji3d.convert_i3d_state_dict(sd)["u"]
    want = _from_jax(ji3d.Unit3D(8, kernel=kernel, strides=strides).apply({"params": params}, _to_jax(x)))
    port.load_state_dict({k[len("u."):]: v for k, v in ti3d.convert_i3d_state_dict(sd).items()})
    got = port(torch.from_numpy(x))
    close(got, want, REL)
    for window, stride in (((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 2, 2)), ((2, 2, 2), (2, 2, 2)), ((3, 3, 3), (1, 1, 1))):
        neg = -np.abs(x)  # all below zero: a zero-padded pool would differ from the -inf one
        want = _from_jax(ji3d._max_pool_same(_to_jax(neg), window, stride))
        np.testing.assert_array_equal(ti3d.max_pool_same(torch.from_numpy(neg), window, stride).numpy(), want)


def test_inception_module_matches_flax():
    x = np.random.default_rng(1).standard_normal((2, 16, 5, 6, 7)).astype(np.float32)
    spec = ji3d._MIXED_SPECS["Mixed_3b"]
    port = ti3d.InceptionModule(16, spec).eval()
    sd = synthetic_sd(port, 2, lambda k: "Mixed_3b." + k)
    want = _from_jax(ji3d.InceptionModule(spec).apply({"params": ji3d.convert_i3d_state_dict(sd)["Mixed_3b"]},
                                                        _to_jax(x)))
    port.load_state_dict({k[len("Mixed_3b."):]: v for k, v in ti3d.convert_i3d_state_dict(sd).items()})
    close(port(torch.from_numpy(x)), want, REL)


@pytest.mark.parametrize("name,args", [("InceptionA", (32,)), ("InceptionB", ()), ("InceptionC", (16,)),
                                       ("InceptionD", ()), ("InceptionE", ("avg",)), ("InceptionE", ("max",))])
def test_inception_blocks_match_flax(name, args):
    """At 9x9 (odd: the stride-2 branches and the excl. average pool's border)."""
    x = np.random.default_rng(3).standard_normal((2, 24, 9, 9)).astype(np.float32)
    port = getattr(tinc, name)(24, *args).eval()
    sd = synthetic_sd(port, 4, lambda k: "Mixed." + k)
    flax = getattr(jinc, name)(*args)
    want = _from_jax(flax.apply({"params": jinc.convert_inception_state_dict(sd)["Mixed"]}, _to_jax(x)))
    port.load_state_dict({k[len("Mixed."):]: v for k, v in tinc.convert_inception_state_dict(sd).items()})
    close(port(torch.from_numpy(x)), want, REL)


@pytest.fixture(scope="module")
def c3d_pair():
    port = tc3d.C3D().eval()
    sd = synthetic_sd(port, 5, lambda k: "module." + k)
    params, mean = jc3d.convert_c3d_state_dict(sd)
    psd, pmean = tc3d.convert_c3d_state_dict(sd)
    port.load_state_dict(psd, strict=True)
    return port, sd, params, mean, psd, pmean


@pytest.mark.parametrize("mean_kind,size", [("channels", 112), ("tensor", 128)])
def test_whole_c3d_detector_matches_flax(c3d_pair, mean_kind, size):
    """The whole C3D at 112^2, batch 1, through both detectors: at 112^2
    with the channel means; at 128^2 (resized to 112^2) with a full
    (C, F, H, W) mean tensor in the checkpoint."""
    port, sd, params, mean, psd, _ = c3d_pair
    rng = np.random.default_rng(6)
    if mean_kind == "tensor":
        sd = dict(sd, mean=torch.from_numpy(rng.uniform(80, 110, (3, 16, 112, 112)).astype(np.float32)))
        params, mean = jc3d.convert_c3d_state_dict(sd)
    _, pmean = tc3d.convert_c3d_state_dict(sd)
    np.testing.assert_array_equal(pmean, mean)
    x = rng.uniform(0, 255, (1, 3, 16, size, size)).astype(np.float32)
    want = jc3d.c3d_flax_detector(params, mean, batch_size=1)(x)
    got = tc3d.c3d_detector(port, pmean, device="cpu")(x)
    assert got.shape == (1, 101) and abs(got.sum() - 1) < 1e-5
    close(got, want, REL)


def test_converters_accept_the_jax_variants_and_carry_flax_back(c3d_pair):
    """Synthetic reference state dicts through both packages' converters:
    pytorch-i3d names with a ``module.`` / ``i3d.`` prefix, the eager head's
    ``Logits``, ``num_batches_tracked``; torchvision names with ``AuxLogits``
    and an ``inception.`` prefix; C3D names with ``c3d.`` / ``module.`` and
    a ``mean``. The port's conversions load strict and equal the JAX
    params carried across by ``convert.flax_*_to_state_dict``."""
    i3d = ti3d.InceptionI3d()
    for prefix in ("module.", "i3d.", "module.i3d."):
        def rename(k):
            return prefix + ("Logits" + k[len("logits"):] if k.startswith("logits") else k)

        sd = synthetic_sd(i3d, 7, rename)
        sd[prefix + "Conv3d_1a_7x7.bn.num_batches_tracked"] = torch.tensor(5)
        port_sd = ti3d.convert_i3d_state_dict(sd)
        i3d.load_state_dict(port_sd, strict=True)
        _same_as_carried(ji3d.convert_i3d_state_dict(sd), port_sd, convert.flax_i3d_to_state_dict)

    inc = tinc.FIDInceptionV3()
    sd = synthetic_sd(inc, 8, lambda k: "inception." + k)
    sd["inception.AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["inception.Mixed_5b.branch1x1.bn.num_batches_tracked"] = torch.tensor(3)
    port_sd = tinc.convert_inception_state_dict(sd)
    inc.load_state_dict(port_sd, strict=True)
    _same_as_carried(jinc.convert_inception_state_dict(sd), port_sd, convert.flax_inception_to_state_dict)

    _, sd, params, mean, psd, pmean = c3d_pair
    _same_as_carried(params, psd, convert.flax_c3d_to_state_dict)
    np.testing.assert_array_equal(pmean, mean)
    c3d_sd = {"c3d." + k[len("module."):]: v for k, v in sd.items()}
    assert set(tc3d.convert_c3d_state_dict(c3d_sd)[0]) == set(tc3d.C3D().state_dict())


class _File(torch.nn.Module):
    """A stand-in for the reference's torchscript detector file: the port's
    module under ``net.`` (a prefix the converters strip); the loader reads
    only the file's weights, so the traced graph passes its input through."""

    def __init__(self, model, mean=None):
        super().__init__()
        self.net = model
        if mean is not None:
            self.register_buffer("mean", mean)

    def forward(self, x):
        return x


@pytest.mark.parametrize("role", ["i3d", "inception", "c3d"])
def test_load_detector_from_a_torchscript_file(role, tmp_path, monkeypatch, request):
    """``load_detector`` reads the file in ``LATTE_TPU_DETECTORS`` into the
    port's module through its converter, C3D's exported ``mean`` with it:
    the same numbers, to the bit, as the module's own detector; so does a
    file path as ``get_detector``'s spec (on C3D, the cheapest). A missing
    directory raises."""
    rng = np.random.default_rng(9)
    mean = None
    if role == "i3d":
        model, x = ti3d.InceptionI3d(), rng.uniform(0, 255, (1, 3, 16, 64, 64))
        model.load_state_dict(ti3d.convert_i3d_state_dict(synthetic_sd(model, 10)))
        want = ti3d.i3d_detector(model, "cpu")
    elif role == "c3d":
        model, x = request.getfixturevalue("c3d_pair")[0], rng.uniform(0, 255, (1, 3, 16, 112, 112))
        mean = torch.tensor([100.0, 90.0, 80.0])
        want = tc3d.c3d_detector(model, mean.numpy(), "cpu")
    else:
        model, x = tinc.FIDInceptionV3(), rng.uniform(0, 255, (1, 3, 64, 48))
        model.load_state_dict(tinc.convert_inception_state_dict(synthetic_sd(model, 12)))
        want = tinc.inception_detector(model, "cpu")
    path = tmp_path / detectors.DETECTOR_FILES[role]
    torch.jit.save(torch.jit.trace(_File(model.eval(), mean), torch.zeros(1)), str(path))
    monkeypatch.setenv("LATTE_TPU_DETECTORS", str(tmp_path))
    fns = {"i3d": [detectors.i3d_features], "c3d": [detectors.c3d_probs],
           "inception": [detectors.inception_features, detectors.inception_probs]}[role]
    clips = np.moveaxis(np.asarray(x, np.float32), 1, -1).astype(np.uint8)
    loaded = [detectors.load_detector(role, device="cpu")]
    if role == "c3d":
        loaded.append(detectors.get_detector(str(path), role, "cpu"))
    for fn in fns:
        ref = fn(want, clips)
        assert np.isfinite(ref).all()
        for got in loaded:
            np.testing.assert_array_equal(fn(got, clips), ref)
    monkeypatch.delenv("LATTE_TPU_DETECTORS")
    with pytest.raises(FileNotFoundError, match="LATTE_TPU_DETECTORS"):
        detectors.load_detector(role, device="cpu")


def test_detectors_run_on_the_card_unless_asked(monkeypatch):
    """No device named: ``cuda``, which raises without a GPU (no fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ti3d.i3d_detector(ti3d.InceptionI3d()), lambda: tc3d.c3d_detector(tc3d.C3D()),
                 lambda: tinc.inception_detector(tinc.FIDInceptionV3())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.slow
def test_whole_i3d_detector_matches_flax():
    """The whole I3D through both detectors with the FVD call (rescale, and
    the 64^2 frames resized to 224^2), 2 clips of 16 frames."""
    port = ti3d.InceptionI3d()
    sd = synthetic_sd(port, 13)
    port.load_state_dict(ti3d.convert_i3d_state_dict(sd))
    x = np.random.default_rng(14).uniform(0, 255, (2, 3, 16, 64, 64)).astype(np.float32)
    flax = ji3d.i3d_flax_detector(ji3d.convert_i3d_state_dict(sd), batch_size=2)
    det = ti3d.i3d_detector(port, device="cpu")
    for kw in (dict(rescale=True, resize=True, return_features=True), dict(rescale=True, resize=True,
                                                                             return_features=False)):
        close(det(x, **kw), flax(x, **kw), REL)


@pytest.mark.slow
def test_whole_inception_detector_matches_flax():
    """The whole FID Inception through both detectors (64^2 images resized
    to 299^2): pool3, the probabilities, and those without the output bias."""
    port = tinc.FIDInceptionV3()
    sd = synthetic_sd(port, 15)
    port.load_state_dict(tinc.convert_inception_state_dict(sd))
    x = np.random.default_rng(16).uniform(0, 255, (2, 3, 64, 64)).astype(np.float32)
    flax = jinc.inception_flax_detector(jinc.convert_inception_state_dict(sd), batch_size=2)
    det = tinc.inception_detector(port, device="cpu")
    for kw in (dict(return_features=True), dict(), dict(no_output_bias=True)):
        close(det(x, **kw), flax(x, **kw), REL)
