"""The port's training step over four processes (gloo on the CPU) against the
JAX step and the one-process port on the same global batch, and the bytes
each rank holds against the JAX shardings.

One spawn of 4 ranks (module fixture) runs ``configs/ffs/ffs_train_moe.yaml``
as shipped (``expert_parallel: 4``, 8 experts, 2 a rank) through
``train.main`` for two steps at the tiny size, and two steps (AdamW lr 1e-3, weight
decay 0.01, clip 0.1, EMA 0.9; the Switch loss at 0.01 for MoE) of each
case: dp 4; dp 2 x ep 2 and dp 1 x ep 4 with 4 experts (top-2, capacity
factor 1.0: tokens drop, and a dispatch group of 64 tokens spans the ranks'
rows); fsdp at dp 4; fsdp at dp 2 x ep 2; zero1 at dp 4. The tiny model:
depth 2, hidden 144, 2 heads, 4 frames of 32x32 (4x4 latents), global batch
4. t and the noise are handed across as tests/test_torch_train_step.py does
(the port's ranks take their rows of them).

Tolerances: against JAX (attention_mode "xla"), loss within 1e-5 relative,
grad norm, every parameter and EMA entry within 1e-4 relative L2, the Switch
loss within 1e-6 relative; against the one-process port, everything within
1e-6 relative L2, the k part of each qkv bias left out there: its gradient
is zero but for rounding (softmax does not see a shift of every key), and
AdamW turns that rounding into steps of up to the learning rate.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import _jax_noise
from torch_dist_util import jobs, one_thread, spawn, step_cases, train_run, wait
from torch_port_util import rel_l2

from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.dist.mesh import MeshConfig, make_mesh
from latte_tpu.dist.sharding import ep_param_shardings, fsdp_param_shardings, zero1_opt_shardings
from latte_tpu.models import Latte as JaxLatte
from latte_tpu.train.state import create_train_state as jax_create_train_state
from latte_tpu.train.state import make_optimizer as jax_make_optimizer
from latte_tpu.train.step import make_train_step as jax_make_train_step
from latte_tpu_torch.convert import flax_to_state_dict
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.dist.sharding import local_numels
from latte_tpu_torch.models import Latte
from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
from latte_tpu_torch.train.step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFS_MOE = os.path.join(REPO, "configs", "ffs", "ffs_train_moe.yaml")
TINY_CLI = ["image_size=32", "num_frames=4", "local_batch_size=2", "max_train_steps=2", "log_every=1",
            "model_overrides={depth: 2, hidden_size: 144, num_heads: 2}"]
WORLD = 4
TINY = dict(input_size=4, patch_size=2, in_channels=4, hidden_size=144, depth=2, num_heads=2, num_frames=4)
MOE = dict(TINY, moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
HP = dict(ema_decay=0.9, clip_max_norm=0.1, start_clip_iter=0)
# (name, model, ep, fsdp, zero1)
CASES = [
    ("dp4", TINY, 1, False, False),
    ("dp2_ep2", MOE, 2, False, False),
    ("dp1_ep4", MOE, 4, False, False),
    ("fsdp_dp4", TINY, 1, True, False),
    ("fsdp_dp2_ep2", MOE, 2, True, False),
    ("zero1_dp4", TINY, 1, False, True),
]
TS = [np.array([3, 700, 250, 999]), np.array([1, 250, 500, 40])]


def _sd(tree):
    return {k: v.float() for k, v in flax_to_state_dict(tree, TINY["depth"], TINY["num_heads"], TINY["patch_size"]).items()}


def _jax_run(kw, params, x0):
    """Two JAX steps on the global batch. XLA compiles the step at backend
    optimization level 0, half the compile's CPU time; the losses move by
    ~1e-8 relative against the default level."""
    aux = 0.01 if kw.get("moe_experts") else 0.0
    jm = JaxLatte(**kw, attention_mode="xla")
    jopt = jax_make_optimizer(lr=1e-3, weight_decay=0.01)
    jstate = jax_create_train_state(params, jopt)
    key, metrics, noises = jax.random.PRNGKey(7), [], []
    batches = [{"latents": jnp.asarray(x0), "t": jnp.asarray(t, jnp.int32)} for t in TS]
    jstep = jax.jit(jax_make_train_step(jm, jax_create_diffusion(""), jopt, moe_aux_weight=aux, **HP)).lower(
        jstate, batches[0], key).compile(compiler_options={"xla_backend_optimization_level": 0})
    for s, batch in enumerate(batches):
        jstate, m = jstep(jstate, batch, key)
        metrics.append({k: float(v) for k, v in m.items() if np.ndim(v) == 0})
        noises.append(_jax_noise(key, s, x0.shape))
    return metrics, _sd(jstate.params), _sd(jstate.ema_params), noises


def _port_run(kw, weights, batches):
    """Two steps of the one-process port on the global batches."""
    model = Latte(**kw)
    model.load_state_dict(weights)
    state = create_train_state(model, make_optimizer(model, 0.01), make_lr_schedule(1e-3))
    step = make_train_step(create_diffusion(""), moe_aux_weight=0.01 if kw.get("moe_experts") else 0.0, **HP)
    metrics = [{k: float(v) for k, v in step(state, b, torch.Generator()).items() if v.ndim == 0} for b in batches]
    return metrics, state.model.state_dict(), state.ema.state_dict()


def _params(kw, x0, seed=1, std=0.1):
    """The JAX model's parameter tree, every leaf N(0, std²) from numpy (as
    torch_port_util.randomize draws them), without running its init."""
    jm = JaxLatte(**kw, attention_mode="xla")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x0), jnp.zeros((4,), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: (std * rng.standard_normal(s.shape)).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 4, 4, 4, 4)).astype(np.float32)
    params = {0: _params(TINY, x0), 4: _params(MOE, x0)}
    weights = {e: _sd(p) for e, p in params.items()}
    noises = [_jax_noise(jax.random.PRNGKey(7), s, x0.shape) for s in range(len(TS))]
    batches = [{"latents": torch.from_numpy(x0), "t": torch.from_numpy(t), "noise": torch.from_numpy(n.copy())}
               for t, n in zip(TS, noises)]
    path = str(tmp_path_factory.mktemp("dist_step") / "data.pt")
    torch.save({"weights": weights, "batches": batches}, path)
    moe_cli = TINY_CLI + [f"results_dir={os.path.dirname(path)}/results"]
    ranks = spawn(jobs, WORLD, [(step_cases, (path, CASES)), (train_run, (FFS_MOE, moe_cli, path + ".moe"))],
                  join=False)
    ref = {e: (params[e], *_jax_run(kw, params[e], x0)) for e, kw in ((0, TINY), (4, MOE))}
    assert all(np.array_equal(a, b) for r in ref.values() for a, b in zip(noises, r[4]))
    with one_thread():
        port = {e: _port_run(kw, weights[e], batches) for e, kw in ((0, TINY), (4, MOE))}
    wait(ranks)
    got = torch.load(path + ".out", weights_only=False)
    moe = [torch.load(f"{path}.moe.{r}", weights_only=False) for r in range(WORLD)]
    return {"got": got, "jax": ref, "port": port, "moe": moe}


def _experts(kw):
    return kw.get("moe_experts", 0)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_step_matches_jax_on_the_global_batch(runs, case):
    name, kw = case[0], case[1]
    got = runs["got"][name]
    _, want_metrics, want_params, want_ema, _ = runs["jax"][_experts(kw)]
    for g, w in zip(got["metrics"], want_metrics):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]), (name, g["loss"], w["loss"])
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-4 * w["grad_norm"], (name, g["grad_norm"], w["grad_norm"])
        if "moe_aux" in w:
            assert abs(g["moe_aux"] - w["moe_aux"]) <= 1e-6 * abs(w["moe_aux"]), (name, g["moe_aux"], w["moe_aux"])
    for which, want in (("model", want_params), ("ema", want_ema)):
        assert set(got[which]) == set(want)
        for k, v in want.items():
            assert rel_l2(got[which][k], v) <= 1e-4, (name, which, k, rel_l2(got[which][k], v))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_step_matches_one_process(runs, case):
    name, kw = case[0], case[1]
    got = runs["got"][name]
    want_metrics, want_params, want_ema = runs["port"][_experts(kw)]
    for g, w in zip(got["metrics"], want_metrics):
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-6 * max(abs(w[k]), 1e-12), (name, k, g[k], w[k])
    for which, want in (("model", want_params), ("ema", want_ema)):
        for k, v in want.items():
            g = got[which][k]
            if k.endswith("qkv.bias"):
                third = v.shape[0] // 3
                g, v = torch.cat([g[:third], g[2 * third:]]), torch.cat([v[:third], v[2 * third:]])
            assert rel_l2(g, v) <= 1e-6, (name, which, k, rel_l2(g, v))


def _jax_numels(params, dp, ep, fsdp, zero1):
    """(parameter, first-moment) elements one device holds under the JAX
    trainer's shardings on a dp x ep mesh of the first dp·ep CPU devices."""
    mesh = make_mesh(MeshConfig(dp=dp, ep=ep), devices=jax.devices()[: dp * ep])

    def count(tree, shardings):
        leaves = jax.tree_util.tree_leaves(tree)
        shs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))
        return sum(int(np.prod(s.shard_shape(np.shape(x)))) for x, s in zip(leaves, shs))

    rep = jax.tree_util.tree_map(lambda x: jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()), params)
    if fsdp:
        p = m = fsdp_param_shardings(params, mesh)
    elif ep > 1:
        p = m = ep_param_shardings(params, mesh)
    elif zero1:
        p, m = rep, zero1_opt_shardings(params, mesh)
    else:
        p = m = rep
    return count(params, p), count(params, m)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_shard_sizes_match_the_jax_shardings(runs, case):
    """Each rank's parameter and moment elements (bytes / 4: all fp32)
    equal a device's under ep_param_shardings, fsdp_param_shardings and
    zero1_opt_shardings, and the port's rule (``local_numels``) predicts
    them."""
    name, kw, ep, fsdp, zero1 = case
    got = runs["got"][name]
    params = runs["jax"][_experts(kw)][0]
    want = _jax_numels(params, WORLD // ep, ep, fsdp, zero1)
    assert all(tuple(n) == want for n in got["numels"]), (name, got["numels"], want)
    shapes = [(k, tuple(v.shape)) for k, v in runs["port"][_experts(kw)][1].items()]
    assert local_numels(shapes, WORLD // ep, ep, fsdp, zero1) == want


def test_ffs_train_moe_as_shipped_trains_on_four_ranks(runs):
    """The shipped MoE config (dp 1 x ep 4) through ``train.main``: each rank
    holds 2 of the 8 experts, every rank logs the same finite metrics, and
    rank 0's one experiment directory holds the full checkpoint (8 experts a
    block) in the one-process format."""
    from latte_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint

    moe = runs["moe"]
    assert [m["experts"] for m in moe] == [2] * WORLD
    first = moe[0]
    assert first["result"]["final_step"] == 2 and len(first["metrics"]) == 2
    assert all(np.isfinite(m["loss"]) and m["moe_aux"] > 0 for m in first["metrics"])
    for m in moe[1:]:
        for got, want in zip(m["metrics"], first["metrics"]):
            assert all(got[k] == want[k] for k in ("loss", "grad_norm", "moe_aux"))
        assert m["result"]["experiment_dir"] == first["result"]["experiment_dir"]
    exp = first["result"]["experiment_dir"]
    assert len(os.listdir(os.path.dirname(exp))) == 1
    payload = load_checkpoint(latest_checkpoint(os.path.join(exp, "checkpoints")))
    assert payload["step"] == 2
    for block in range(2):
        assert payload["model"][f"blocks.{block}.moe.wi"].shape[0] == 8
        assert payload["ema"][f"blocks.{block}.moe.wo"].shape[0] == 8
    assert not any(k.startswith("module.") for k in payload["model"])
