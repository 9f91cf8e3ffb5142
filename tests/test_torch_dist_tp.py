"""Tensor and sequence parallelism and ring attention over four processes
(gloo on the CPU), against the JAX package and the one-process port.

One spawn of 4 ranks (module fixture) runs:

- two steps of ``make_train_step`` (AdamW lr 1e-3, weight decay 0.01, clip
  0.1, EMA 0.9; the Switch loss at 0.01 for MoE) on the global batch of 4 of
  tests/test_torch_dist_step.py (its tiny model at 4 heads, and its MoE
  model), for tp 2 x dp 2, tp 4, tp 2 with zero1 and with fsdp at dp 2, tp 2
  x ep 2 (MoE), sp 4,
  sp 2 x tp 2, and AdamW's first moment in bf16 under zero1 and under fsdp
  (at dp 2 x tp 2);
- ring attention at sp 2 (x dp 2) and sp 4 on the same numpy q, k, v as
  JAX's ``ring_attention_sharded`` on an sp mesh of the virtual CPU
  devices: the output and the q/k/v gradients of sum(out²); a tiny Latte and
  a tiny LatteT2V in ring mode at sp 4 against the JAX models in ring mode
  (tests/test_ring_attention.py's models), and a Latte of 3 frames whose
  temporal attention falls back to the standard one;
- ``train.main`` on ``configs/ffs/ffs_train.yaml`` at the tiny size (4
  heads) from randomized ``pretrained`` weights with ``tensor_parallel=4``
  and with ``sequence_parallel=4``, 3 steps, against one process at the
  same global batch;
- ``sample.main`` with ``tensor_parallel=4`` from a checkpoint, dynamic int8
  (``quantized: true``), against one process.

Tolerances: against JAX, loss within 1e-5 relative, grad norm, every
parameter and EMA entry within 1e-4 relative L2 (test_torch_dist_step.py's);
against the one-process port 1e-6 (metrics relative, tensors relative L2; the
k part of each qkv bias left out, as there); the bf16 first moments' cases'
parameters within DIST_BF16_MU_REL (see its comment). Ring attention within
2e-5 of JAX
(tests/test_ring_attention.py's bound), the ring models within 3e-5.
"""

import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_dist_step import MOE, TINY, TS, _params, _port_run
from test_torch_train_step import _jax_noise
from torch_dist_util import Record, context, jobs, mesh_step_cases, one_thread, spawn, train_run, wait
from torch_port_util import close, rel_l2

from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.dist.mesh import MeshConfig as JaxMeshConfig
from latte_tpu.dist.mesh import make_mesh as jax_make_mesh
from latte_tpu.dist.ring import ring_attention_sharded as jax_ring
from latte_tpu.dist.sharding import ep_param_shardings, fsdp_param_shardings, param_shardings
from latte_tpu.models import Latte as JaxLatte
from latte_tpu.models.t2v import LatteT2V as JaxLatteT2V
from latte_tpu.train.state import create_train_state as jax_create_train_state
from latte_tpu.train.state import make_optimizer as jax_make_optimizer
from latte_tpu.train.step import make_train_step as jax_make_train_step
from latte_tpu_torch.config import load_config
from latte_tpu_torch.convert import flax_t2v_to_state_dict, flax_to_state_dict
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.dist.sharding import local_numels, tp_shard, tp_shard_state_dict, tp_unshard
from latte_tpu_torch.dist.tp import virtual_tp
from latte_tpu_torch.models import Latte, get_models
from latte_tpu_torch.models.layers import AdaLNBlock, Attention
from latte_tpu_torch.sample import sample
from latte_tpu_torch.train import train
from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
from latte_tpu_torch.train.step import make_train_step

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFS_TRAIN = os.path.join(REPO, "configs", "ffs", "ffs_train.yaml")
FFS_SAMPLE = os.path.join(REPO, "configs", "ffs", "ffs_sample.yaml")
# the dense cases' model: tests/test_torch_dist_step.py's at 4 heads, so tp 4 holds one
TINY4 = dict(TINY, num_heads=4)
HP = dict(ema_decay=0.9, clip_max_norm=0.1, start_clip_iter=0)
# (name, model, weights key, mesh, fsdp, zero1, bf16 first moment)
CASES = [
    ("tp2_dp2", TINY4, 4, dict(tp=2), False, False, False),
    ("tp4", TINY4, 4, dict(tp=4), False, False, False),
    ("tp2_zero1", TINY4, 4, dict(tp=2), False, True, False),
    ("tp2_fsdp", TINY4, 4, dict(tp=2), True, False, False),
    ("tp2_ep2", MOE, "moe", dict(tp=2, ep=2), False, False, False),
    ("sp4", TINY4, 4, dict(sp=4), False, False, False),
    ("sp2_tp2", TINY4, 4, dict(sp=2, tp=2), False, False, False),
    ("zero1_mu_bf16", TINY4, 4, dict(tp=2), False, True, True),
    ("fsdp_mu_bf16", TINY4, 4, dict(tp=2), True, False, True),
]
# the reference runs: (JAX model, port weights key, bf16 first moment)
REFS = {"tiny4": (TINY4, 4, False), "moe": (MOE, "moe", False), "tiny4_mu_bf16": (TINY4, 4, True)}
# AdamW with bf16 first moments rounds each m to bf16: where a gradient sits a
# few fp32 ulp from a bf16 rounding boundary, the sharded and the one-process
# m land one bf16 step (2^-8 relative) apart, and the update moves that
# element by up to lr·2^-8 ≈ 4e-6 (lr 1e-3, |m|/sqrt(v) ≈ 1 in the first
# steps) against weights of ~0.1: 4e-5 relative on a few elements, ~2e-6
# over a tensor (blocks.1.attn.qkv.bias: 1.7e-6); the fp32 cases hold 1e-6
DIST_BF16_MU_REL = 1e-5
ARCH = ["image_size=32", "num_frames=4", "local_batch_size=2", "log_every=1", "learning_rate=1e-3",
        "max_train_steps=3", "ckpt_every=3"]
ARCH4 = ARCH + ["model_overrides={depth: 2, hidden_size: 144, num_heads: 4}"]
SAMPLE4 = ["model_overrides={depth: 4, hidden_size: 32, num_heads: 4}", "image_size=32", "num_frames=2",
           "use_fp16=false", "sample_method=ddim", "num_sampling_steps=3", "quantized=true"]
# ring attention's inputs and models (tests/test_ring_attention.py's)
RB, RN, RH, RD = 2, 64, 2, 16
RING_LATTE = dict(input_size=16, patch_size=2, num_frames=4, extras=1, learn_sigma=True, hidden_size=32, depth=2,
                  num_heads=2)
RING_T2V = dict(num_attention_heads=2, attention_head_dim=16, num_layers=2, patch_size=2, sample_size=16,
                cross_attention_dim=32, caption_channels=64, video_length=4)


def _case(c):
    name, kw, weights, mesh, fsdp, zero1, bf16 = c
    return dict(name=name, kw=kw, weights=weights, fsdp=fsdp, zero1=zero1,
                mu_dtype=torch.bfloat16 if bf16 else None, **mesh)


def _ref_key(case) -> str:
    if case[6]:
        return "tiny4_mu_bf16"
    return "moe" if case[1].get("moe_experts") else "tiny4"


def _jax_run(kw, params, x0):
    """Two JAX steps on the global batch (tests/test_torch_dist_step.py's,
    at XLA's optimization level 0), the parameters and EMA in the port's
    names at the model's head count."""
    jm = JaxLatte(**kw, attention_mode="xla")
    jopt = jax_make_optimizer(lr=1e-3, weight_decay=0.01)
    jstate = jax_create_train_state(params, jopt)
    key, metrics = jax.random.PRNGKey(7), []
    batches = [{"latents": jnp.asarray(x0), "t": jnp.asarray(t, jnp.int32)} for t in TS]
    aux = 0.01 if kw.get("moe_experts") else 0.0
    jstep = jax.jit(jax_make_train_step(jm, jax_create_diffusion(""), jopt, moe_aux_weight=aux, **HP)).lower(
        jstate, batches[0], key).compile(compiler_options={"xla_backend_optimization_level": 0})
    for batch in batches:
        jstate, m = jstep(jstate, batch, key)
        metrics.append({k: float(v) for k, v in m.items() if np.ndim(v) == 0})
    sd = lambda tree: {k: v.float() for k, v in flax_to_state_dict(tree, 2, kw["num_heads"], 2).items()}  # noqa
    return metrics, sd(jstate.params), sd(jstate.ema_params)


def _port_run_mu(kw, weights, batches, mu_dtype):
    """:func:`_port_run` with AdamW's first moment in ``mu_dtype``."""
    model = Latte(**kw)
    model.load_state_dict(weights)
    state = create_train_state(model, make_optimizer(model, 0.01, mu_dtype=mu_dtype), make_lr_schedule(1e-3))
    step = make_train_step(create_diffusion(""), **HP)
    metrics = [{k: float(v) for k, v in step(state, b, torch.Generator()).items() if v.ndim == 0} for b in batches]
    return metrics, state.model.state_dict(), state.ema.state_dict()


def _ring_inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((RB, RN, RH, RD)).astype(np.float32) for _ in range(3)]


def ring_job(rank: int, world: int, path: str) -> None:
    """Ring attention at sp 2 (dp 2) and sp 4 on the saved inputs, the ring
    models in ring mode at sp 4; rank 0 saves what the tests read."""
    from latte_tpu_torch.dist.ring import ring_attention, ring_attention_sharded
    from latte_tpu_torch.models.t2v import LatteT2V

    data = torch.load(path, weights_only=False)
    out = {}
    for sp in (2, 4):
        ctx = context(sp=sp)
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in data["qkv"])
        o = ring_attention_sharded(q, k, v, ctx)
        o.square().sum().backward()
        out[f"sp{sp}"] = (o.detach(), q.grad, k.grad, v.grad)
        # the ring on this rank's blocks alone: its block of the same output
        # and gradients (those of k and v summed over every query block)
        n = RN // sp
        rows = slice(ctx.sp_rank * n, (ctx.sp_rank + 1) * n)
        qb, kb, vb = (torch.from_numpy(a[:, rows].copy()).requires_grad_() for a in data["qkv"])
        ob = ring_attention(qb, kb, vb, ctx.sp_group)
        ob.square().sum().backward()
        blocks = [torch.empty_like(t) for t in (ob, qb.grad, kb.grad, vb.grad) for _ in range(sp)]
        for i, t in enumerate((ob.detach(), qb.grad, kb.grad, vb.grad)):
            torch.distributed.all_gather(blocks[i * sp:(i + 1) * sp], t.contiguous(), group=ctx.sp_group)
        out[f"blocks_sp{sp}"] = tuple(torch.cat(blocks[i * sp:(i + 1) * sp], dim=1) for i in range(4))
    ctx = context(sp=4)
    for name, frames in (("latte", 4), ("latte_f3", 3)):
        model = Latte(**dict(RING_LATTE, num_frames=frames), attention_mode="ring", ring_mesh=ctx)
        model.load_state_dict(data[name]["weights"])
        with torch.no_grad():
            out[name] = model(*(torch.from_numpy(a) for a in data[name]["inputs"]))
    t2v = LatteT2V(**RING_T2V, attention_mode="ring", ring_mesh=ctx)
    t2v.load_state_dict(data["t2v"]["weights"], strict=True)
    with torch.no_grad():
        out["t2v"] = t2v(*(torch.from_numpy(a) for a in data["t2v"]["inputs"]))
    if rank == 0:
        torch.save(out, path + ".ring")


def sample_job(rank: int, world: int, config_path: str, overrides) -> None:
    sample.main(load_config(config_path, list(overrides)), device="cpu")


def _random_params(module, seed, *inputs):
    """The JAX module's parameter tree, every leaf N(0, 0.1²) from numpy,
    from its shapes alone (an eager init on the virtual devices costs far
    more CPU than the checks)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), shapes)


def _ring_refs(tmp):
    """The JAX side of the ring checks (a mesh of 4 virtual CPU devices),
    and the weights and inputs the ranks take."""
    q, k, v = (jnp.asarray(a) for a in _ring_inputs())
    refs = {}
    for sp in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))

        def loss(q, k, v, mesh=mesh):
            out = jax_ring(q, k, v, mesh)
            return jnp.sum(out**2), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        refs[f"sp{sp}"] = tuple(np.asarray(a) for a in (out, *grads))
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    data = {"qkv": _ring_inputs()}
    t = np.array([7, 300], np.int32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 4, 4, 16, 16)))
    params = _random_params(JaxLatte(**RING_LATTE, attention_mode="xla"), 2, x, t)  # the same at 3 frames
    for name, frames in (("latte", 4), ("latte_f3", 3)):
        kw = dict(RING_LATTE, num_frames=frames)
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, frames, 4, 16, 16)))
        ring = JaxLatte(**kw, attention_mode="ring", ring_mesh=mesh, ring_axis="sp")
        refs[name] = np.asarray(jax.jit(lambda p, x, t: ring.apply({"params": p}, x, t))(params, x, t))  # noqa: B023
        data[name] = {"weights": flax_to_state_dict(params, 2, 2, 2), "inputs": (x, t.astype(np.int64))}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 4, 4, 32, 32)))
    t = np.array([21.0], np.float32)
    ctx = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 10, 64)))
    mask = np.ones((1, 10), np.int32)
    params = _random_params(JaxLatteT2V(**RING_T2V, attention_mode="xla"), 3, x, t, ctx, mask)
    ring = JaxLatteT2V(**RING_T2V, attention_mode="ring", ring_mesh=mesh)
    refs["t2v"] = np.asarray(jax.jit(lambda p, *a: ring.apply({"params": p}, *a))(params, x, t, ctx, mask))
    data["t2v"] = {"weights": flax_t2v_to_state_dict(params), "inputs": (x, t, ctx, mask)}
    path = str(tmp / "ring.pt")
    torch.save(data, path)
    return path, refs


def _pretrained(tmp) -> str:
    """``pretrained=`` a checkpoint of ARCH4's model with every weight
    N(0, 0.1²) from a seed (the reference init's zero adaLN gates would
    leave the blocks out of the first step's loss)."""
    model = get_models(load_config(FFS_TRAIN, ARCH4))
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.1, generator=gen)
    torch.save({"ema": model.state_dict()}, tmp / "pretrained.pt")
    return f"pretrained={tmp / 'pretrained.pt'}"


def _sampler_ckpt(tmp) -> str:
    """A randomized checkpoint of SAMPLE4's model (the adaLN and output
    layers carry signal)."""
    model = sample.build_model(load_config(FFS_SAMPLE, SAMPLE4[:-1]), torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.1, generator=gen)
    path = str(tmp / "sampler.pt")
    torch.save({"ema": model.state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_tp")
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 4, 4, 4, 4)).astype(np.float32)
    params = {4: _params(TINY4, x0), "moe": _params(MOE, x0)}
    weights = {4: flax_to_state_dict(params[4], 2, 4, 2), "moe": flax_to_state_dict(params["moe"], 2, 2, 2)}
    weights = {k: {n: v.float() for n, v in w.items()} for k, w in weights.items()}
    noises = [_jax_noise(jax.random.PRNGKey(7), s, x0.shape) for s in range(len(TS))]
    batches = [{"latents": torch.from_numpy(x0), "t": torch.from_numpy(t), "noise": torch.from_numpy(n.copy())}
               for t, n in zip(TS, noises)]
    path = str(tmp / "data.pt")
    torch.save({"weights": weights, "batches": batches}, path)
    ring_path, ring_refs = _ring_refs(tmp)
    ckpt = _sampler_ckpt(tmp)
    pre = _pretrained(tmp)
    todo = [(mesh_step_cases, (path, [_case(c) for c in CASES])),
            (ring_job, (ring_path,)),
            (train_run, (FFS_TRAIN, ARCH4 + ["tensor_parallel=4", pre, f"results_dir={tmp}/tp4"], str(tmp / "tp4"))),
            (train_run, (FFS_TRAIN, ARCH4 + ["sequence_parallel=4", pre, f"results_dir={tmp}/sp4"],
                         str(tmp / "sp4"))),
            (sample_job, (FFS_SAMPLE, SAMPLE4 + [f"ckpt={ckpt}", "tensor_parallel=4",
                                                 f"save_video_path={tmp}/tp4s/v.mp4"]))]
    ranks = spawn(jobs, WORLD, todo, join=False)
    jax_ref = {"tiny4": _jax_run(TINY4, params[4], x0), "moe": _jax_run(MOE, params["moe"], x0)}
    one = {}
    with one_thread():
        port = {name: _port_run_mu(kw, weights[key], batches, torch.bfloat16 if bf16 else None)
                if not kw.get("moe_experts") else _port_run(kw, weights[key], batches)
                for name, (kw, key, bf16) in REFS.items()}
        rec = Record()
        train.main(load_config(FFS_TRAIN, ARCH4 + [pre, f"results_dir={tmp}/one"]), callbacks=[rec], device="cpu")
        one["train"] = rec.metrics
        one["sample"] = np.load(sample.main(load_config(FFS_SAMPLE, SAMPLE4 + [
            f"ckpt={ckpt}", f"save_video_path={tmp}/one_s/v.mp4"]), device="cpu"))["latents"]
    wait(ranks)
    return {"tmp": tmp, "params": params, "weights": weights, "got": torch.load(path + ".out", weights_only=False), "jax": jax_ref,
            "port": port, "ring": torch.load(ring_path + ".ring", weights_only=False), "ring_refs": ring_refs,
            "train": {n: torch.load(f"{tmp}/{n}.0", weights_only=False) for n in ("tp4", "sp4")}, "one": one,
            "sample": np.load(tmp / "tp4s" / "v_latents.npz")["latents"]}


def _metric_close(got, want, rel, keys=None):
    for g, w in zip(got, want):
        for k in keys or w:
            assert abs(g[k] - w[k]) <= rel * max(abs(w[k]), 1e-12), (k, g[k], w[k])


@pytest.mark.parametrize("case", [c for c in CASES if not c[6]], ids=[c[0] for c in CASES if not c[6]])
def test_step_matches_jax_on_the_global_batch(runs, case):
    got = runs["got"][case[0]]
    want_metrics, want_params, want_ema = runs["jax"][_ref_key(case)]
    _metric_close(got["metrics"], want_metrics, 1e-5, ["loss"])
    _metric_close(got["metrics"], want_metrics, 1e-4, ["grad_norm"])
    if case[1].get("moe_experts"):
        _metric_close(got["metrics"], want_metrics, 1e-6, ["moe_aux"])
    for which, want in (("model", want_params), ("ema", want_ema)):
        assert set(got[which]) == set(want)
        for k, v in want.items():
            assert rel_l2(got[which][k], v) <= 1e-4, (case[0], which, k, rel_l2(got[which][k], v))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_step_matches_one_process(runs, case):
    """Every case against the one-process port on the same weights and
    batches; the LayerNorm-fed adaLN modulations, the embedders and the
    final layer come out equal too, which they do only with the backward
    all-reduce of the column-parallel layers' input gradient."""
    got = runs["got"][case[0]]
    want_metrics, want_params, want_ema = runs["port"][_ref_key(case)]
    _metric_close(got["metrics"], want_metrics, 1e-6)
    rel = DIST_BF16_MU_REL if case[6] else 1e-6
    for which, want in (("model", want_params), ("ema", want_ema)):
        assert set(got[which]) == set(want)
        for k, v in want.items():
            g = got[which][k]
            if k.endswith("qkv.bias"):
                third = v.shape[0] // 3
                g, v = torch.cat([g[:third], g[2 * third:]]), torch.cat([v[:third], v[2 * third:]])
            assert rel_l2(g, v) <= rel, (case[0], which, k, rel_l2(g, v))
    start = runs["weights"][case[2]]
    for k in ("x_embedder.proj.weight", "t_embedder.mlp.0.weight", "blocks.0.adaLN_modulation.1.weight"):
        assert rel_l2(want_params[k], start[k]) > 1e-3, k  # these trained: their match above means something


def _jax_numels(params, mesh_kw, fsdp, zero1):
    """(parameter, first-moment) elements one device holds under the JAX
    trainer's shardings on the mesh of the first dp·ep·sp·tp CPU devices,
    and the port's moments under zero1 (its tp shard's, split over dp)."""
    cfg = JaxMeshConfig(dp=WORLD // (mesh_kw.get("tp", 1) * mesh_kw.get("sp", 1) * mesh_kw.get("ep", 1)),
                        tp=mesh_kw.get("tp", 1), sp=mesh_kw.get("sp", 1), ep=mesh_kw.get("ep", 1))
    mesh = jax_make_mesh(cfg, devices=jax.devices()[:WORLD])

    def shapes(tree, shardings):
        leaves = jax.tree_util.tree_leaves(tree)
        shs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))
        return [s.shard_shape(np.shape(x)) for x, s in zip(leaves, shs)]

    if fsdp:
        sh = fsdp_param_shardings(params, mesh)
    elif cfg.ep > 1:
        sh = ep_param_shardings(params, mesh)
    elif cfg.tp > 1:
        sh = param_shardings(params, mesh)
    else:
        sh = jax.tree_util.tree_map(lambda x: jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()),
                                    params)
    local = shapes(params, sh)
    p = sum(int(np.prod(s)) for s in local)
    if not zero1:
        return p, p
    m = 0
    for s in local:
        n = int(np.prod(s))
        big = [d for d in s if d % cfg.dp == 0]
        m += n // cfg.dp if big and max(big) >= cfg.dp else n
    return p, m


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_shard_sizes_match_the_jax_shardings(runs, case):
    """Each rank's parameter and moment elements equal a device's under
    param_shardings and its compositions with ep_param_shardings and
    fsdp_param_shardings (sequence parallelism replicates the parameters),
    and the port's rule (``local_numels``) predicts them. Under zero1 the
    port's moments are its tp shard's split over dp (the JAX trainer's
    zero1_opt_shardings replicates them over tp, more bytes a device)."""
    name, kw, _, mesh_kw, fsdp, zero1, _ = case
    got = runs["got"][name]
    params = runs["params"]["moe" if kw.get("moe_experts") else 4]
    want = _jax_numels(params, mesh_kw, fsdp, zero1)
    assert all(tuple(n) == want for n in got["numels"]), (name, got["numels"], want)
    shapes = [(k, tuple(v.shape)) for k, v in runs["port"][_ref_key(case)][1].items()]
    dp = WORLD // (mesh_kw.get("tp", 1) * mesh_kw.get("sp", 1) * mesh_kw.get("ep", 1))
    assert local_numels(shapes, dp, mesh_kw.get("ep", 1), fsdp, zero1, mesh_kw.get("tp", 1)) == want


@pytest.mark.parametrize("blocks", [False, True], ids=["sharded", "blocks"])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax(runs, sp, blocks):
    """The port's ring (B1 with its logsumexp, the fp32 merge; B4/B5 with the
    merged lse and delta) over sp ranks against JAX's ring_attention_sharded
    on an sp mesh: output and the gradients of sum(out²) within 2e-5, from
    whole q, k, v (``ring_attention_sharded``) and from each rank's blocks
    (``ring_attention``, the blocks gathered)."""
    got = runs["ring"][f"{'blocks_' if blocks else ''}sp{sp}"]
    for g, want, what in zip(got, runs["ring_refs"][f"sp{sp}"], ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), want, atol=2e-5, err_msg=what)


@pytest.mark.parametrize("name", ["latte", "latte_f3", "t2v"])
def test_ring_models_match_jax_ring_models(runs, name):
    """A tiny Latte and a tiny LatteT2V in ring mode at sp 4 against the JAX
    models in ring mode on 4 devices (within tests/test_ring_attention.py's
    3e-5); ``latte_f3``'s temporal attention (3 frames) falls back to the
    standard attention, as the JAX model's does."""
    np.testing.assert_allclose(runs["ring"][name].numpy(), runs["ring_refs"][name], atol=3e-5)


@pytest.mark.parametrize("name", ["tp4", "sp4"])
def test_train_main_matches_one_process(runs, name):
    """``train.main`` on ffs_train.yaml (the tiny size at 4 heads, from
    randomized ``pretrained`` weights) at tensor_parallel=4 and at
    sequence_parallel=4, global batch 2: the logged losses and grad norms of
    the one-process run at the same batch within 1e-6."""
    got, want = runs["train"][name], runs["one"]["train"]
    assert [m["step"] for m in got["metrics"]] == [1, 2, 3] and got["result"]["final_step"] == 3
    _metric_close(got["metrics"], want, 1e-6, ["loss", "grad_norm"])


def test_tensor_parallel_sampler_matches_one_process(runs):
    """``sample.main`` at tensor_parallel=4 with dynamic int8 (each token's
    amax all-reduced over tp in the row-parallel layers) against one
    process on the same checkpoint; rank 0 wrote the latents."""
    close(runs["sample"], runs["one"]["sample"], 1e-5, 1e-4)
    assert np.abs(runs["one"]["sample"]).max() > 0.1


# -- in one process -----------------------------------------------------------

def _full_pair(seed=0, heads=4, width=64):
    """A full-width block pair's spatial block with random weights (the
    adaLN modulation carrying signal)."""
    torch.manual_seed(seed)
    blk = AdaLNBlock(width, heads)
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0, 0.1)
    return blk


def _shards(blk, tp, cut=tp_shard):
    """The block's tp shards, built at tensor_parallel ``tp`` without a
    group, their weights cut by ``cut``."""
    shards = []
    for r in range(tp):
        s = AdaLNBlock(blk.attn.num_heads * blk.attn.head_dim, blk.attn.num_heads, tp=tp)
        s.load_state_dict({k: cut(f"blocks.0.{k}", v, tp, r) for k, v in blk.state_dict().items()})
        shards.append(s)
    return shards


@pytest.mark.parametrize("tp", [2, 4])
def test_virtual_tp_equals_the_whole_block(tp):
    """A block's tp shards run in turn with the row-parallel sums taken by
    hand (``virtual_tp``, chip_smoke.py's check) against the whole block:
    the output, the input's gradient and every weight's gradient (the
    shards' gradients joined by ``tp_unshard``) within 1e-5 relative L2."""
    blk = _full_pair()
    x = torch.randn(3, 8, 64, requires_grad=True)
    c = torch.randn(3, 64)
    out = blk(x, c)
    out.square().sum().backward()
    shards = _shards(blk, tp)
    xs = x.detach().clone().requires_grad_()
    got = virtual_tp(shards)(xs, c)
    got.square().sum().backward()
    assert rel_l2(got.detach(), out.detach()) <= 1e-5 and rel_l2(xs.grad, x.grad) <= 1e-5
    for k, p in blk.named_parameters():
        grads = [dict(s.named_parameters())[k].grad for s in shards]
        if grads[1] is None:  # replicated: the first shard's serves
            g = grads[0]
        else:
            g = tp_unshard(f"blocks.0.{k}", grads)
        assert rel_l2(g, p.grad) <= 1e-5, (k, rel_l2(g, p.grad))


def test_qkv_split_is_by_heads_in_the_q_k_v_layout():
    """A tp rank's qkv rows are its heads of q, of k and of v (the port's
    [q|k|v] rows); a contiguous split of the rows gives another block."""
    blk = _full_pair()
    w = blk.attn.qkv.weight.detach()
    part = tp_shard("blocks.0.attn.qkv.weight", w, 2, 1)
    C = w.shape[1]
    assert torch.equal(part, w.view(3, 4, 16, C)[:, 2:4].reshape(-1, C))
    assert torch.equal(tp_unshard("blocks.0.attn.qkv.weight", [tp_shard("blocks.0.attn.qkv.weight", w, 2, r)
                                                               for r in range(2)]), w)
    x, c = torch.randn(2, 8, 64), torch.randn(2, 64)
    with torch.no_grad():
        want = blk(x, c)
        good = virtual_tp(_shards(blk, 2))(x, c)

        def contiguous(name, t, tp, rank):
            if ".qkv." in name:
                n = t.shape[0] // tp
                return t[rank * n:(rank + 1) * n]
            return tp_shard(name, t, tp, rank)

        bad = virtual_tp(_shards(blk, 2, contiguous))(x, c)
    assert rel_l2(good, want) <= 1e-6 and rel_l2(bad, want) > 1e-2


def test_tp_shard_state_dict_cuts_the_int8_buffers_with_their_weights():
    """The serving buffers follow their weights: weight_i8 as the weight, a
    column layer's per-channel scale by its rows, the per-head q/k/v
    scales by heads; per-tensor scales and row-parallel biases are whole."""
    sd = {"blocks.0.attn.qkv.weight_i8": torch.arange(12 * 4).view(12, 4),
          "blocks.0.attn.qkv.weight_scale": torch.arange(12.0).view(12, 1),
          "blocks.0.attn.proj.weight_i8": torch.arange(16).view(4, 4),
          "blocks.0.attn.proj.weight_scale": torch.arange(4.0).view(4, 1),
          "blocks.0.attn.proj.bias": torch.arange(4.0), "blocks.0.attn.proj.act_scale": torch.tensor(3.0),
          "blocks.0.attn.q_scale": torch.arange(2.0), "blocks.0.mlp.fc1.bias": torch.arange(8.0),
          "blocks.0.adaLN_modulation.1.weight": torch.ones(24, 4), "final_layer.linear.weight": torch.ones(8, 4)}
    got = tp_shard_state_dict(sd, 2, 1)
    assert torch.equal(got["blocks.0.attn.qkv.weight_i8"], sd["blocks.0.attn.qkv.weight_i8"][[2, 3, 6, 7, 10, 11]])
    assert torch.equal(got["blocks.0.attn.qkv.weight_scale"].view(-1), torch.tensor([2.0, 3, 6, 7, 10, 11]))
    assert torch.equal(got["blocks.0.attn.proj.weight_i8"], sd["blocks.0.attn.proj.weight_i8"][:, 2:])
    assert torch.equal(got["blocks.0.attn.q_scale"], torch.tensor([1.0]))
    assert torch.equal(got["blocks.0.mlp.fc1.bias"], torch.arange(4.0, 8.0))
    for k in ("blocks.0.attn.proj.weight_scale", "blocks.0.attn.proj.bias", "blocks.0.attn.proj.act_scale",
              "blocks.0.adaLN_modulation.1.weight", "final_layer.linear.weight"):
        assert torch.equal(got[k], sd[k]), k


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_virtual_ring_equals_whole_attention(n):
    """The ring's schedule in one process (chip_smoke.py's virtual ring):
    forward and q/k/v gradients against the plain whole-sequence attention
    and its backward, within 1e-6 of the largest magnitude."""
    from latte_tpu_torch.dist.ring import virtual_ring_attention
    from latte_tpu_torch.kernels.attention import attention_backward_reference, attention_reference

    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _ring_inputs())
    out = virtual_ring_attention(q, k, v, n)
    dout = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    want, lse = attention_reference(q.detach(), k.detach(), v.detach(), return_lse=True)
    want_grads = attention_backward_reference(q.detach(), k.detach(), v.detach(), want, lse, dout)
    for g, w in zip((out, *grads), (want, *want_grads)):
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()


def test_ring_mode_refusals_and_the_int8_warning():
    """Ring mode without a group raises the JAX model's ValueError; int8
    attention in ring mode warns that the ring has no int8 core and runs in
    the model's type (a ring of one here: the standard attention)."""
    with pytest.raises(ValueError, match="requires constructing the model with ring_mesh"):
        Attention(32, 2, attention_mode="ring")
    with pytest.raises(ValueError, match="requires constructing the model with ring_mesh"):
        Latte(**RING_LATTE, attention_mode="ring")
    one = types.SimpleNamespace(sp=1, sp_group=None)
    attn = Attention(32, 2, attention_mode="ring", ring_mesh=one, quantized="static", int8_attention=True)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, b in attn.named_buffers():
            if name.endswith("weight_i8"):
                b.copy_(torch.randint(-127, 128, b.shape, generator=gen))
        for p in attn.parameters():
            p.normal_(0, 0.5, generator=gen)
    ref = Attention(32, 2, quantized="static")
    ref.load_state_dict({k: v for k, v in attn.state_dict().items() if not k.endswith(("q_scale", "k_scale",
                                                                                            "v_scale"))})
    x = torch.randn(2, 8, 32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = attn(x)
    assert any("has no int8 core" in str(w.message) for w in caught)
    assert torch.equal(got, ref(x))


@pytest.mark.parametrize("override, world, error, match", [
    ("pipeline_parallel=2 pp_microbatches=3", 2, AssertionError, r"per-forward batch 5 \(global 5 / grad_accum 1\) "
                                                                 r"not divisible by pp_microbatches=3"),
    ("pipeline_parallel=2 tensor_parallel=2", 4, ValueError, "composes with data parallelism only"),
    ("pipeline_parallel=2 fsdp=true", 2, ValueError, "already shards the block stack"),
    ("tensor_parallel=2 sequence_parallel=2", 2, AssertionError, "must divide 2 devices"),
    ("tensor_parallel=3", 4, AssertionError, "tensor_parallel=3 x sequence_parallel=1 .* must divide 4 devices"),
    ("model=LatteIMG-XL/2 sequence_parallel=2", 2, ValueError, "no activation_sharding"),
], ids=["pp", "pp_tp", "pp_fsdp", "mesh", "tp3", "img_sp"])
def test_mesh_refusals(override, world, error, match):
    """The JAX trainer's mesh errors (with pipeline parallelism: a
    per-forward batch the microbatches do not divide, tp, fsdp) and
    LatteIMG with sequence parallelism, before any process group."""
    with pytest.raises(error, match=match):
        train.check_config(load_config(FFS_TRAIN, override.split()), world)
    train.check_config(load_config(FFS_TRAIN, ["tensor_parallel=2", "sequence_parallel=2", "fsdp=true"]), 8)
    with pytest.raises(ValueError, match="no activation_sharding"):
        from latte_tpu_torch.models.dit_img import LatteIMG

        LatteIMG(**dict(TINY, depth=2), mesh=types.SimpleNamespace(tp=1, sp=2))


def test_sampler_refusals(tmp_path):
    """As the JAX sampler: tensor-parallel serving needs loop_mode: scan;
    and it needs as many processes as tp (one here)."""
    base = SAMPLE4 + [f"save_video_path={tmp_path}/v.mp4"]
    with pytest.raises(ValueError, match="tensor_parallel serving requires loop_mode=scan"):
        sample.main(load_config(FFS_SAMPLE, base + ["tensor_parallel=2", "loop_mode=host"]), device="cpu")
    with pytest.raises(ValueError, match="tensor_parallel=2 needs 2 processes"):
        sample.main(load_config(FFS_SAMPLE, base + ["tensor_parallel=2"]), device="cpu")
    assert not any(tmp_path.iterdir())
