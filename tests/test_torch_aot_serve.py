"""Serving artifacts of the port (``latte_tpu_torch/serve/aot.py``,
``serve/export_aot.py``) on the JAX AOT tests' tiny model
(tests/test_aot_serve.py: hidden 32, depth 4, 2 heads, 2 frames, 2x2
latents, patch 1, DDIM-4), exported on the CPU from fake tensors.

- The artifact's latents equal the port's live ``sample.sample_loop`` to the
  bit: unconditional, CFG at batch 2, DDPM from a generator, the block cache
  (1, 2) and ``quantized: static`` with int8 attention.
- Against JAX's live sampler (``build_sample_fn``) on the same weights,
  carried over by ``convert.flax_to_state_dict``, the same z (DDIM) and the
  same injected noise (DDPM): ``close(1e-5, 1e-4)``, the port's parity
  tolerance for one fp32 function summed in another order.
- The refusals (another batch, a foreign magic, a JAX artifact), no state-dict
  entry in the file, a ``cuda`` artifact exported on this CPU host holding the
  custom ops and refusing to load here, and the ``export_aot`` CLI.
- Tensor-parallel artifacts at world 2 over gloo (one spawn,
  ``tests/torch_dist_util.py``) against the one-process live sampler within
  JAX's bound for its tp artifacts, ``rtol=2e-5, atol=2e-6``.
"""

import io
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import close, one_cpu_thread, randomize

from latte_tpu.config import load_config as jax_load_config
from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.models import get_models as jax_get_models
from latte_tpu.sample.sample import build_sample_fn
from latte_tpu_torch.config import load_config
from latte_tpu_torch.convert import flax_to_state_dict
from latte_tpu_torch.kernels import ops
from latte_tpu_torch.sample import sample
from latte_tpu_torch.serve import aot, export_aot
from test_torch_sample import FFS

TINY = [
    "model_overrides={depth: 4, hidden_size: 32, num_heads: 2, patch_size: 1}",
    "image_size=16", "num_frames=2", "use_fp16=false", "sample_method=ddim", "num_sampling_steps=4",
    "ckpt=null",
]
CASES = {
    "uncond": [],
    "cfg": ["extras=2", "num_classes=10", "cfg_scale=2.0"],
    "ddpm": ["sample_method=ddpm"],
    "block_cache": ["block_cache_interval=2", "block_cache_pairs=1"],
    "int8_static": ["quantized=static", "attention_mode=flash", "int8_attention=true"],
}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_cpu_thread():
        yield


def _jax_params(jm, extras):
    x0, t0 = jnp.zeros((1, 2, 4, 2, 2)), jnp.zeros((1,), jnp.int32)
    rngs = {"params": jax.random.PRNGKey(0)}
    kw = {}
    if extras == 2:
        rngs["label_dropout"] = jax.random.PRNGKey(1)
        kw["y"] = jnp.zeros((1,), jnp.int32)
    return randomize(jm.init(rngs, x0, t0, **kw)["params"], seed=3, std=0.1)


def _setup(case, tmp_path):
    """The configs, the JAX model and params, and the port's live model
    built by the sampler from a checkpoint of those params."""
    over = TINY + CASES[case]
    cfg, jcfg = load_config(FFS, over), jax_load_config(FFS, over)
    extras = int(getattr(cfg, "extras", 1))
    jm = jax_get_models(jcfg)
    params = _jax_params(jm, extras)
    torch.save({"ema": flax_to_state_dict(params, 4, 2, 1)}, tmp_path / "c.pt")
    cfg.ckpt = str(tmp_path / "c.pt")
    model = sample.build_model(cfg, CPU)
    return cfg, jcfg, jm, params, model


def _artifact(cfg, tmp_path, batch=1, device="cpu", name="a"):
    out = export_aot.main(cfg, str(tmp_path / name), batch=batch, device=device)
    return out, aot.load_sampler(out) if device == "cpu" else None


def _z(shape, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_equals_the_live_sampler_to_the_bit(case, tmp_path):
    cfg, _, _, _, model = _setup(case, tmp_path)
    batch = 2 if case == "cfg" else 1
    path, call = _artifact(cfg, tmp_path, batch=batch)
    hdr = call.header
    assert hdr["cfg"] == (case == "cfg") and hdr["takes_y"] == (case == "cfg")
    assert hdr["block_cache"] == ([1, 2] if case == "block_cache" else None)
    assert hdr["quantized"] == ("static" if case == "int8_static" else False)
    assert hdr["device"] == "cpu" and hdr["z_shape"] == [batch, 2, 4, 2, 2]
    z = _z((batch, 2, 4, 2, 2))
    y = torch.tensor([1, 4]) if case == "cfg" else None
    got = call(model.state_dict(), z, y, generator=torch.Generator().manual_seed(7))
    want = sample.sample_loop(model, cfg, z, y, torch.Generator().manual_seed(7))
    assert got.shape == want.shape == (batch, 2, 4, 2, 2)
    assert torch.equal(got, want), (got - want).abs().max()


@pytest.mark.parametrize("case", list(CASES))
def test_gpu_less_export_graph_equals_the_live_sampler(case, tmp_path, monkeypatch):
    """A host without CUDA exports for the card under ``_FakeCudaIndexing``,
    which records its indexing and ``contiguous`` through other ops; the
    graph it records, exported here for the CPU, still gives the live
    sampler's latents to the bit."""
    monkeypatch.setattr(aot, "_indexing_mode", lambda device: aot._FakeCudaIndexing())
    cfg, _, _, _, model = _setup(case, tmp_path)
    batch = 2 if case == "cfg" else 1
    _, call = _artifact(cfg, tmp_path, batch=batch)
    z = _z((batch, 2, 4, 2, 2))
    y = torch.tensor([1, 4]) if case == "cfg" else None
    got = call(model.state_dict(), z, y, generator=torch.Generator().manual_seed(7))
    want = sample.sample_loop(model, cfg, z, y, torch.Generator().manual_seed(7))
    assert torch.equal(got, want), (got - want).abs().max()


def test_concurrent_calls_keep_their_own_weights(tmp_path):
    """Two requests in two threads, each with its own weights, each get the
    latents of their own weights."""
    cfg, _, _, _, model = _setup("uncond", tmp_path)
    _, call = _artifact(cfg, tmp_path)
    z = _z((1, 2, 4, 2, 2))
    other = {k: v * 0.5 if v.is_floating_point() else v for k, v in model.state_dict().items()}
    with torch.no_grad():
        want = [call(model.state_dict(), z), call(other, z)]
    assert not torch.equal(*want)
    got = [None, None]

    def serve(i, weights):
        for _ in range(2):
            got[i] = call(weights, z)

    threads = [threading.Thread(target=serve, args=(0, model.state_dict())), threading.Thread(target=serve, args=(1, other))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("method", ["ddim", "ddpm"])
def test_artifact_against_the_jax_live_sampler(method, tmp_path):
    """The same weights and z; DDPM with JAX's per-step noise
    ``normal(fold_in(rng, t))`` injected as ``noise_schedule``."""
    cfg, jcfg, jm, params, model = _setup("uncond" if method == "ddim" else "ddpm", tmp_path)
    _, call = _artifact(cfg, tmp_path)
    z = _z((1, 2, 4, 2, 2))
    rng = jax.random.PRNGKey(7)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, t), z.shape, jnp.float32))
                      for t in range(4)])
    got = call(model.state_dict(), z, noise_schedule=torch.from_numpy(noise))
    fn, use_cfg = build_sample_fn(jm, {"params": params}, jcfg, jax_create_diffusion("4"))
    assert not use_cfg
    close(got, fn(jnp.asarray(z.numpy()), None, rng))


def test_refusals(tmp_path):
    from latte_tpu.models import get_model as jax_get_model
    from latte_tpu.serve.aot import export_sampler as jax_export_sampler
    from latte_tpu.serve.aot import save_sampler as jax_save_sampler

    cfg, _, _, _, model = _setup("uncond", tmp_path)
    path, call = _artifact(cfg, tmp_path)
    with pytest.raises(ValueError, match="exported for"):  # the calling convention is pinned
        call(model.state_dict(), _z((2, 2, 4, 2, 2)))
    with pytest.raises(KeyError, match="missing"):
        call({k: v for k, v in model.state_dict().items() if k != "final_layer.linear.bias"}, _z((1, 2, 4, 2, 2)))
    junk = tmp_path / "junk.ltpu-aot"
    junk.write_bytes(b"NOTANART" + b"\x00" * 16)
    with pytest.raises(ValueError, match="not a latte-tpu AOT artifact"):
        aot.load_sampler(str(junk))
    # a file written by the JAX package's save_sampler
    jm = jax_get_model("Latte-S/2", input_size=2, num_frames=2, attention_mode="xla", hidden_size=32,
                       depth=4, num_heads=2, patch_size=1)
    jparams = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2, 4, 2, 2)), jnp.zeros((1,), jnp.int32))
    exported, header = jax_export_sampler(jm, jax_load_config(FFS, TINY), jax_create_diffusion("4"), jparams,
                                          platforms=("cpu",))
    jax_path = jax_save_sampler(str(tmp_path / "jax.ltpu-aot"), exported, header)
    with pytest.raises(ValueError, match="JAX"):
        aot.load_sampler(jax_path)


@pytest.mark.parametrize("case", ["uncond", "block_cache"])
def test_no_state_dict_entry_in_the_file(case, tmp_path):
    cfg, _, _, _, model = _setup(case, tmp_path)
    path, _ = _artifact(cfg, tmp_path)
    header, blobs = aot.read_artifact(path)
    state = model.state_dict()
    assert [name for name, *_ in header["state"]] == list(state)
    weight_bytes = sum(v.numel() * v.element_size() for v in state.values())
    for blob in blobs.values():
        ep = torch.export.load(io.BytesIO(blob))
        assert dict(ep.state_dict) == {}
        assert not set(ep.constants) & set(state)
        assert all(k.startswith(("model_table_", "diffusion_")) for k in ep.constants), list(ep.constants)
        const_bytes = sum(v.numel() * v.element_size() for v in ep.constants.values())
        assert const_bytes < weight_bytes / 20, (const_bytes, weight_bytes)
        inputs = [s.arg.name for s in ep.graph_signature.input_specs if s.kind.name == "USER_INPUT"]
        assert len(inputs) >= len(state)


def _graph_ops(blob):
    ep = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    return {op: targets.count(op.replace("::", ".") + ".default") for op in ops.OPS}, targets


@pytest.mark.parametrize("case", ["uncond", "int8_static"])
def test_cuda_artifact_from_fake_tensors_holds_the_ops_and_refuses_this_host(case, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the export and refusal of a CPU-only host")
    cfg = load_config(FFS, TINY + CASES[case] + ["use_fp16=true"])
    path, _ = _artifact(cfg, tmp_path, device="cuda")
    header, blobs = aot.read_artifact(path)
    assert header["device"] == "cuda" and header["dtype"] == "bfloat16"
    counts, targets = _graph_ops(blobs["step"])
    want = {"latte_tpu_torch::ln_modulate": 4, "latte_tpu_torch::residual_ln_modulate": 4}
    if case == "int8_static":
        want.update({"latte_tpu_torch::flash_attention": 0, "latte_tpu_torch::flash_attention_int8": 4})
    else:
        want.update({"latte_tpu_torch::flash_attention": 4, "latte_tpu_torch::flash_attention_int8": 0})
    assert counts == want
    # the kernels' plain versions would show their softmax's row maximum
    assert not any("amax" in t for t in targets)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aot.load_sampler(path)


def test_export_cli_writes_a_loadable_artifact(tmp_path):
    cfg, _, _, _, model = _setup("uncond", tmp_path)
    out = export_aot.cli(["--config", FFS, "--out", str(tmp_path / "cli"), "--device", "cpu",
                          *TINY, f"ckpt={tmp_path / 'missing.pt'}"])  # the ckpt is not read
    assert out == str(tmp_path / "cli.ltpu-aot") and os.path.getsize(out) < 4_000_000
    call = aot.load_sampler(out)
    z = _z((1, 2, 4, 2, 2))
    assert torch.equal(call(model.state_dict(), z), sample.sample_loop(model, cfg, z))


def test_tp2_artifacts_against_the_one_process_sampler(tmp_path):
    """Tensor-parallel artifacts (plain and with the block cache) exported on
    the CPU from fake tensors, loaded in each rank of one spawn of 2 gloo
    processes with the whole state dict, against the one-process live
    sampler within JAX's bound for its tp artifacts (tests/test_aot_serve.py:
    ``rtol=2e-5, atol=2e-6``; the all-reduces sum in another order). Without
    a process group the loader refuses."""
    from torch_dist_util import aot_tp_run, spawn

    cfg, _, _, _, model = _setup("uncond", tmp_path)
    variants = {"plain": [], "block_cache": ["block_cache_interval=2", "block_cache_pairs=1"]}
    paths, wants = [], []
    z = _z((1, 2, 4, 2, 2))
    for name, over in variants.items():
        c = load_config(FFS, TINY + over)
        paths.append(export_aot.main(c, str(tmp_path / f"tp2_{name}"), device="cpu", tensor_parallel=2))
        wants.append(sample.sample_loop(model, c, z))
    assert aot.read_artifact(paths[0])[0]["tensor_parallel"] == 2
    torch.save(model.state_dict(), tmp_path / "state.pt")
    torch.save(z, tmp_path / "z.pt")
    spawn(aot_tp_run, 2, paths, str(tmp_path / "state.pt"), str(tmp_path / "z.pt"), str(tmp_path))
    for i, want in enumerate(wants):
        for rank in range(2):
            got = torch.load(tmp_path / f"aot{i}.{rank}.pt")
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-6)
    with pytest.raises(ValueError, match="tensor_parallel=2"):
        aot.load_sampler(paths[0])
