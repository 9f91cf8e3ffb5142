"""Pipeline parallelism (latte_tpu_torch/dist/pipeline.py) against the JAX
package's pipelined functions and the one-process port.

In one process: the GPipe schedule alone with the virtual pipeline
(``LocalHop``) at S in {2, 4} and M in {1, 2, 4} against the units applied in
turn, forward and gradients, and the unit offset each stage sees (the
port's ``TestGpipe``, tests/test_pipeline.py:21); a train step through the
virtual pipeline against the one-model step (chip_smoke.py's phase "pp one
card" at a tiny size); the pipelined apply's and the trainer's refusals.

Two spawns over gloo (tests/torch_dist_util.py), each a stage a process:

- world 2 (pp 2): the pipelined forwards of Latte at extras 1, 2 and 78,
  LatteIMG's joint training with label dropout (the JAX model's drops
  handed across; and the port's own drops against one process) and its
  video-only eval forward, LatteT2V with a mask, and the gradients of
  mean(out²) with and without remat, against JAX's pipelined functions on a
  2-device CPU mesh and the one-process port (tests/test_pipeline.py:118,
  135, 160, 220, 263, 280, 314); ``train.main`` on ffs_train.yaml at
  ``pipeline_parallel=2``: two steps and their checkpoint against one
  process's, a resume from one process's checkpoint, and an MoE config whose
  Switch loss is turned off with the JAX trainer's warning; ``sample_t2x``
  at ``pipeline_parallel=2`` against one process and JAX's
  ``LattePipeline(pp_mesh=)`` (tests/test_pipeline_t2v.py:71);
- world 4: two train steps at dp 2 x pp 2 and at pp 4, with and without
  zero1, against the one-process port and JAX's ``make_pipelined_apply``
  step on a (dp 2, pp 2) mesh (tests/test_pipeline.py:341); each rank's
  block parameters (1/S of the model's); LatteT2V at pp 4 without a mask;
  ``train.main`` on ffs_img_train.yaml (LatteIMG) at dp 2 x pp 2 with
  zero1 against one process.

Tolerances (fp32): against the one-process port 1e-6 (metrics relative,
tensors relative L2, the k part of each qkv bias left out as in
tests/test_torch_dist_step.py: its gradient is zero but for rounding, and
AdamW turns that rounding into steps of up to the learning rate); against
JAX 1e-4 relative L2 (and the loss 1e-5, as there); ``sample_t2x``'s
latents within ``close``'s defaults of JAX's (the sampler tests' bound).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from test_torch_dist_step import HP, TS, _port_run
from test_torch_train_cond import _drop_kwargs, _jax_drops
from test_torch_train_step import _jax_noise
from torch_dist_util import (
    Record,
    jobs,
    one_thread,
    pp_forward_cases,
    pp_step_cases,
    resume_run,
    sample_t2x_run,
    spawn,
    train_run,
    wait,
)
from torch_port_util import close, rel_l2

from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.core.scheduler import get_scheduler as jax_get_scheduler
from latte_tpu.dist.pipeline import make_pipelined_apply as jax_make_pipelined_apply
from latte_tpu.dist.pipeline import pipelined_latte_forward as jax_pipelined_latte
from latte_tpu.dist.pipeline import pipelined_latte_img_forward as jax_pipelined_img
from latte_tpu.dist.pipeline import pipelined_t2v_forward as jax_pipelined_t2v
from latte_tpu.models import Latte as JaxLatte
from latte_tpu.models.dit_img import LatteIMG as JaxLatteIMG
from latte_tpu.models.t2v import LatteT2V as JaxLatteT2V
from latte_tpu.sample.pipeline_t2v import LattePipeline as JaxPipeline
from latte_tpu.train.state import create_train_state as jax_create_train_state
from latte_tpu.train.state import make_optimizer as jax_make_optimizer
from latte_tpu.train.step import make_train_step as jax_make_train_step
from latte_tpu_torch.config import load_config
from latte_tpu_torch.convert import flax_t2v_to_state_dict, flax_to_state_dict, load_flax_params
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.dist.pipeline import (
    LocalHop,
    gpipe,
    make_pipelined_apply,
    pipelined_latte_forward,
)
from latte_tpu_torch.models import Latte
from latte_tpu_torch.models.dit_img import LatteIMG
from latte_tpu_torch.models.t2v import LatteT2V
from latte_tpu_torch.sample import sample_t2x
from latte_tpu_torch.text import StubTextEncoder
from latte_tpu_torch.train import train
from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
from latte_tpu_torch.train.step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFS_TRAIN = os.path.join(REPO, "configs", "ffs", "ffs_train.yaml")
T2V_SAMPLE = os.path.join(REPO, "configs", "t2x", "t2v_sample.yaml")
FFS_IMG_TRAIN = os.path.join(REPO, "configs", "ffs", "ffs_img_train.yaml")
# the forwards' models: tests/test_pipeline.py's at 8 blocks (4 pairs)
LATTE = dict(input_size=8, patch_size=2, num_frames=4, learn_sigma=True, hidden_size=32, depth=8, num_heads=2,
             num_classes=10)
# LatteIMG with tests/test_torch_train_cond.py's classes (its drop detection reads the null row 5) and
# dropout rate of 0.5, so drops and kept labels occur
IMG = dict(LATTE, extras=2, use_image_num=2, class_dropout_prob=0.5, num_classes=5)
T2V = dict(num_attention_heads=2, attention_head_dim=16, num_layers=4, patch_size=2, sample_size=8,
           cross_attention_dim=32, caption_channels=64, video_length=4)
# the train steps' model: 8 blocks, hidden 32, 2 heads, 4 frames of 4x4 latents
STEP = dict(input_size=4, patch_size=2, in_channels=4, hidden_size=32, depth=8, num_heads=2, num_frames=4)
# (name, pp, zero1, microbatches) at world 4
STEP_CASES = [("dp2_pp2", 2, False, 2), ("dp2_pp2_zero1", 2, True, 2), ("pp4", 4, False, 4),
              ("pp4_zero1", 4, True, 4)]
ARCH = ["image_size=32", "num_frames=4", "local_batch_size=2", "log_every=1", "learning_rate=1e-3",
        "pp_microbatches=2", "model_overrides={depth: 4, hidden_size: 32, num_heads: 2}"]
T2X = ["num_attention_heads=2", "attention_head_dim=8", "num_layers=2", "caption_channels=32",
       "cross_attention_dim=16", "image_size=[32,32]", "num_sampling_steps=2", "use_fp16=false", "video_length=4",
       "seed=3", "text_prompt=[a cat on a skateboard]"]
PROMPT = "a cat on a skateboard"


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("pp",))


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` at XLA's backend optimization
    level 0 (half the compile's CPU time; tests/test_torch_dist_step.py's)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


def _random(init, seed):
    """The parameter tree ``init`` makes, every leaf N(0, 0.1²) from numpy,
    from its shapes alone."""
    shapes = jax.eval_shape(init)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), shapes)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 4, 4, 8, 8)).astype(np.float32)
    x_img = rng.standard_normal((4, 6, 4, 8, 8)).astype(np.float32)
    t = np.array([3, 500, 77, 901], np.int64)
    y = np.array([1, 2, 3, 4], np.int64)
    y_img = np.array([[1, 2], [3, 4], [0, 1], [2, 3]], np.int64)
    txt = rng.standard_normal((4, 77, 768)).astype(np.float32)
    xt = rng.standard_normal((4, 4, 4, 16, 16)).astype(np.float32)
    tt = (np.arange(4) * 100 + 3).astype(np.float32)
    ctx = rng.standard_normal((4, 10, 64)).astype(np.float32)
    mask = (np.arange(10)[None, :] < (5 + np.arange(4)[:, None])).astype(np.int64)
    return dict(x=x, x_img=x_img, t=t, y=y, y_img=y_img, txt=txt, xt=xt, tt=tt, ctx=ctx, mask=mask)


def _forward_cases():
    """Each forward case: its JAX model, parameters, the port's inputs and
    the JAX reference's function."""
    a = _inputs()
    k = jax.random.PRNGKey(0)
    cases = {}
    for extras in (1, 2, 78):
        jm = JaxLatte(**LATTE, extras=extras, attention_mode="xla")
        y = a["y"] if extras == 2 else None
        txt = a["txt"] if extras == 78 else None
        params = _random(lambda jm=jm, y=y, txt=txt: jm.init(k, a["x"], a["t"], y=y, text_embedding=txt), extras)
        cases[f"latte_e{extras}"] = dict(kind="latte", kw=dict(LATTE, extras=extras), jm=jm, params=params,
                                         args=(a["x"], a["t"], y), kwargs=dict(text_embedding=txt), M=2)
    for remat in (False, True):
        jm = JaxLatte(**LATTE, attention_mode="xla", gradient_checkpointing=remat)
        cases[f"grad_remat{int(remat)}"] = dict(cases["latte_e1"], jm=jm, grad=True,
                                                kw=dict(LATTE, gradient_checkpointing=remat))
    jm = JaxLatteIMG(**IMG, attention_mode="xla")
    params = _random(lambda: jm.init({"params": k, "label_dropout": k}, a["x_img"], a["t"], y=a["y"],
                                     y_image=a["y_img"], train=True), 4)
    img = dict(kind="img", kw=IMG, jm=jm, params=params, M=2)
    cases["img_train"] = dict(img, args=(a["x_img"], a["t"], a["y"], a["y_img"]), kwargs=dict(train=True))
    cases["img_train_drop"] = dict(img, args=(a["x_img"], a["t"], a["y"], a["y_img"]),
                                   kwargs=dict(train=True, generator_seed=11))
    cases["img_eval"] = dict(img, args=(a["x"], a["t"], a["y"]), kwargs={})
    jm = JaxLatteT2V(**T2V, attention_mode="xla")
    params = _random(lambda: jm.init(k, a["xt"], a["tt"], a["ctx"], a["mask"]), 5)
    t2v = dict(kind="t2v", kw=T2V, jm=jm, params=params)
    cases["t2v_mask"] = dict(t2v, args=(a["xt"], a["tt"], a["ctx"], a["mask"]), M=2)
    cases["t2v_pp4"] = dict(t2v, args=(a["xt"], a["tt"], a["ctx"], None), M=4)
    return cases


def _jax_forward(name, case):
    """The JAX package's pipelined function on a mesh of the case's stages."""
    jm, params, args = case["jm"], case["params"], [None if v is None else jnp.asarray(v) for v in case["args"]]
    mesh = _mesh(4 if name == "t2v_pp4" else 2)
    if case["kind"] == "t2v":
        fn = lambda p, *a: jax_pipelined_t2v(jm, {"params": p}, *a, mesh=mesh, microbatches=case["M"])  # noqa
        return np.asarray(_compiled(fn, params, *args)(params, *args))
    if case["kind"] == "img":
        train_ = case["kwargs"].get("train", False)
        rng = jax.random.PRNGKey(7)
        fn = lambda p, *a: jax_pipelined_img(jm, {"params": p}, *a, mesh=mesh, microbatches=2,  # noqa
                                             train=train_, dropout_rng=rng if train_ else None)
        return np.asarray(_compiled(fn, params, *args)(params, *args))
    txt = case["kwargs"]["text_embedding"]

    def fwd(p):
        return jax_pipelined_latte(jm, {"params": p}, *args, mesh=mesh, microbatches=2,
                                   text_embedding=None if txt is None else jnp.asarray(txt))

    if not case.get("grad"):
        return np.asarray(_compiled(fwd, params)(params))

    def loss(p):
        out = fwd(p)
        return jnp.mean(out**2), out

    (_, out), grads = _compiled(jax.value_and_grad(loss, has_aux=True), params)(params)
    return np.asarray(out), flax_to_state_dict(grads, LATTE["depth"], LATTE["num_heads"], 2)


def _tensor(v):
    return v if v is None or isinstance(v, (bool, int, torch.Tensor)) else torch.as_tensor(v)


def _port_forward(case):
    """The one-process port: the model's own forward on the same weights."""
    if case["kind"] == "t2v":
        model = LatteT2V(**case["kw"])
        model.load_state_dict(flax_t2v_to_state_dict(case["params"]), strict=True)
    else:
        model = load_flax_params((LatteIMG if case["kind"] == "img" else Latte)(**case["kw"]), case["params"])
    kwargs = {k: _tensor(v) for k, v in case.get("kwargs", {}).items()}
    if "generator_seed" in kwargs:
        kwargs["generator"] = torch.Generator().manual_seed(kwargs.pop("generator_seed"))
    args = [None if a is None else torch.as_tensor(a) for a in case["args"]]
    with torch.set_grad_enabled(case.get("grad", False)):
        out = model(*args, **kwargs)
    grads = None
    if case.get("grad"):
        out.square().mean().backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
    return out.detach(), grads


def _jax_step(params, x0, mesh_shape):
    """Two steps of the JAX train step through ``make_pipelined_apply`` on a
    (dp, pp) mesh of the virtual CPU devices, t and noise as
    tests/test_torch_dist_step.py's; the parameters and EMA in the port's
    names."""
    jm = JaxLatte(**STEP, attention_mode="xla")
    jopt = jax_make_optimizer(lr=1e-3, weight_decay=0.01)
    jstate = jax_create_train_state(params, jopt)
    mesh = Mesh(np.array(jax.devices()[: mesh_shape[0] * mesh_shape[1]]).reshape(mesh_shape), ("dp", "pp"))
    step = jax_make_train_step(jm, jax_create_diffusion(""), jopt,
                               apply_fn=jax_make_pipelined_apply(jm, mesh, microbatches=2), **HP)
    key, metrics = jax.random.PRNGKey(7), []
    with mesh:
        batches = [jax.tree_util.tree_map(lambda v: jax.device_put(v, NamedSharding(mesh, P("dp"))),
                                          {"latents": jnp.asarray(x0), "t": jnp.asarray(t, jnp.int32)}) for t in TS]
        jstep = _compiled(step, jstate, batches[0], key)
        for batch in batches:
            jstate, m = jstep(jstate, batch, key)
            metrics.append({k: float(v) for k, v in m.items() if np.ndim(v) == 0})
    sd = lambda tree: {k: v.float() for k, v in flax_to_state_dict(tree, STEP["depth"], 2, 2).items()}  # noqa
    return metrics, sd(jstate.params), sd(jstate.ema_params)


def _pretrained(tmp) -> str:
    """``pretrained=`` a checkpoint of ARCH's model with every weight
    N(0, 0.1²) from a seed (the reference init's zero adaLN gates would
    leave the blocks out of the losses)."""
    from latte_tpu_torch.models import get_models

    model = get_models(load_config(FFS_TRAIN, ARCH))
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.1, generator=gen)
    torch.save({"ema": model.state_dict()}, tmp / "pretrained.pt")
    return f"pretrained={tmp / 'pretrained.pt'}"


def _t2x_ckpt(tmp):
    """A safetensors LatteT2V checkpoint of T2X's architecture from JAX
    parameters N(0, 0.1²), and the JAX model."""
    from safetensors.torch import save_file

    arch = sample_t2x.transformer_kwargs(load_config(T2V_SAMPLE, T2X))
    jm = JaxLatteT2V(**{k: v for k, v in arch.items() if not k.startswith("moe") and k != "attention_mode"},
                     attention_mode="xla")
    params = _random(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 4, 4, 4, 4)), jnp.zeros((2,)),
                                     jnp.zeros((2, 120, 32)), None), 8)
    save_file(flax_t2v_to_state_dict(params), str(tmp / "t2v.safetensors"))
    return jm, params, f"ckpt={tmp / 't2v.safetensors'}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_pp")
    cases = _forward_cases()
    a = _inputs()
    rng = jax.random.PRNGKey(7)
    # the JAX model's label drops of the joint batch, handed to the port
    drops = _jax_drops(cases["img_train"]["jm"], cases["img_train"]["params"], a["x_img"], a["t"], rng,
                       y=jnp.asarray(a["y"]), y_image=jnp.asarray(a["y_img"]))
    cases["img_train"]["kwargs"] = dict(train=True, **_drop_kwargs(drops))
    fwd_path = str(tmp / "forward.pt")
    torch.save({n: {k: v for k, v in c.items() if k != "jm"} for n, c in cases.items() if n != "t2v_pp4"}, fwd_path)
    fwd4_path = str(tmp / "forward4.pt")
    torch.save({"t2v_pp4": {k: v for k, v in cases["t2v_pp4"].items() if k != "jm"}}, fwd4_path)

    x0 = np.random.default_rng(0).standard_normal((4, 4, 4, 4, 4)).astype(np.float32)
    step_params = _random(lambda: JaxLatte(**STEP, attention_mode="xla").init(
        jax.random.PRNGKey(0), jnp.asarray(x0), jnp.zeros((4,), jnp.int32)), 1)
    noises = [_jax_noise(jax.random.PRNGKey(7), s, x0.shape) for s in range(len(TS))]
    batches = [{"latents": torch.from_numpy(x0), "t": torch.from_numpy(t), "noise": torch.from_numpy(n.copy())}
               for t, n in zip(TS, noises)]
    step_path = str(tmp / "step.pt")
    torch.save({"params": step_params, "kw": STEP, "batches": batches, "cases": STEP_CASES}, step_path)

    pre = _pretrained(tmp)
    # LatteIMG's ffs_img_train.yaml at dp 2 x pp 2 with zero1: each rank 2 of the global 4 rows
    img = ARCH + [pre, "use_image_num=2", "max_train_steps=2"]
    todo4 = [(pp_step_cases, (step_path,)), (pp_forward_cases, (fwd4_path,)),
             (train_run, (FFS_IMG_TRAIN, img + ["pipeline_parallel=2", "zero1=true", f"results_dir={tmp}/img"],
                          str(tmp / "img")))]
    ranks4 = spawn(jobs, 4, todo4, join=False)
    # one process before the world-2 ranks: the resume starts from its step-2 checkpoint
    one = {}
    rec = Record()
    train.main(load_config(FFS_TRAIN, ARCH + [pre, "max_train_steps=3", "ckpt_every=2", f"results_dir={tmp}/one"]),
               callbacks=[rec], device="cpu")
    one["train"] = rec.metrics
    jm_t2x, t2x_params, ckpt = _t2x_ckpt(tmp)
    pp2 = ARCH + [pre, "pipeline_parallel=2"]
    todo2 = [(pp_forward_cases, (fwd_path,)),
             (train_run, (FFS_TRAIN, pp2 + ["max_train_steps=2", "ckpt_every=2", f"results_dir={tmp}/pp2"],
                          str(tmp / "pp2"))),
             (resume_run, (FFS_TRAIN, pp2 + ["max_train_steps=3", "ckpt_every=3", f"results_dir={tmp}/resume"],
                           str(tmp / "one"), str(tmp / "resume"))),
             (train_run, (FFS_TRAIN, pp2 + ["moe_experts=2", "max_train_steps=1", f"results_dir={tmp}/moe"],
                          str(tmp / "moe"))),
             (sample_t2x_run, (T2V_SAMPLE, T2X + [ckpt, "pipeline_parallel=2", f"save_video_path={tmp}/t2x_pp2"],
                               str(tmp / "t2x_pp2")))]
    ranks2 = spawn(jobs, 2, todo2, join=False)
    jax_fwd = {n: _jax_forward(n, c) for n, c in cases.items() if n != "img_train_drop"}
    jax_step = _jax_step(step_params, x0, (2, 2))
    jp = JaxPipeline(transformer=jm_t2x, transformer_params={"params": t2x_params},
                     scheduler=jax_get_scheduler("DDIM"), text_encoder=StubTextEncoder(32),
                     pp_mesh=_mesh(2), pp_microbatches=2)
    z = torch.randn((1, 4, 4, 4, 4), generator=torch.Generator().manual_seed(3)).numpy()
    jp.prepare_latents = lambda *args, num_inference_steps=50: (
        jnp.asarray(z) * jp.scheduler.init_noise_sigma_for(num_inference_steps))
    cfg = load_config(T2V_SAMPLE, T2X + [ckpt])
    jax_t2x = np.asarray(jp(PROMPT, video_length=4, height=32, width=32, num_inference_steps=2,
                            guidance_scale=float(cfg.guidance_scale), output_type="latents").video)
    with one_thread():
        port_fwd = {n: _port_forward(c) for n, c in cases.items()}
        weights = {k: v.float() for k, v in flax_to_state_dict(step_params, STEP["depth"], 2, 2).items()}
        port_step = _port_run(STEP, weights, batches)
        one["t2x"] = sample_t2x.main(load_config(T2V_SAMPLE, T2X + [ckpt, f"save_video_path={tmp}/t2x_one"]),
                                     device="cpu")[0]["latents"]
        rec = Record()
        train.main(load_config(FFS_IMG_TRAIN, img + ["local_batch_size=4", f"results_dir={tmp}/img_one"]),
                   callbacks=[rec], device="cpu")
        one["img"] = rec.metrics
    wait(ranks2)
    wait(ranks4)
    fwd = torch.load(fwd_path + ".fwd", weights_only=False)
    fwd.update(torch.load(fwd4_path + ".fwd", weights_only=False))
    return dict(tmp=tmp, cases=cases, fwd=fwd, jax_fwd=jax_fwd, port_fwd=port_fwd, jax_step=jax_step,
                port_step=port_step, step=torch.load(step_path + ".step", weights_only=False), one=one,
                jax_t2x=jax_t2x, train={n: torch.load(f"{tmp}/{n}.0", weights_only=False) for n in
                                        ("pp2", "resume", "moe", "img")},
                t2x=[torch.load(f"{tmp}/t2x_pp2.{r}", weights_only=False) for r in range(2)])


def _without_k_bias(k, v):
    """A qkv bias without its k third (its gradient is zero but for
    rounding, see the module docstring); any other tensor as it is."""
    if k.endswith("qkv.bias"):
        third = v.shape[0] // 3
        return torch.cat([v[:third], v[2 * third:]])
    return v


def _dicts_close(got, want, rel, label):
    assert set(got) == set(want), (label, sorted(set(got) ^ set(want))[:6])
    for k, v in want.items():
        g, w = _without_k_bias(k, torch.as_tensor(got[k]).float()), _without_k_bias(k, torch.as_tensor(v).float())
        err = rel_l2(g, w) if float(w.norm()) > 0 else float(g.abs().max())
        assert err <= rel, (label, k, err)


FORWARDS = ["latte_e1", "latte_e2", "latte_e78", "img_train", "img_eval", "t2v_mask", "t2v_pp4"]


@pytest.mark.parametrize("name", FORWARDS)
def test_pipelined_forward_matches_jax_and_one_process(runs, name):
    """Each pipelined forward over gloo (pp 2; ``t2v_pp4`` at pp 4) against
    JAX's pipelined function on as many devices (1e-4) and the one-process
    port's model forward (1e-6); the joint LatteIMG batch with the JAX
    model's label drops handed across."""
    got = runs["fwd"][name]["out"]
    assert rel_l2(got, runs["jax_fwd"][name]) <= 1e-4, (name, rel_l2(got, runs["jax_fwd"][name]))
    assert rel_l2(got, runs["port_fwd"][name][0]) <= 1e-6, (name, rel_l2(got, runs["port_fwd"][name][0]))


def test_label_dropout_draws_as_one_process(runs):
    """LatteIMG's joint forward drawing its own label drops (``y`` then
    ``y_image``) from the generator on each stage: the one-process model's
    drops, so its output to 1e-6."""
    got, want = runs["fwd"]["img_train_drop"]["out"], runs["port_fwd"]["img_train_drop"][0]
    assert rel_l2(got, want) <= 1e-6
    assert rel_l2(want, runs["port_fwd"]["img_train"][0]) > 1e-3  # other drops than JAX's: the draw counts


@pytest.mark.parametrize("remat", [0, 1], ids=["plain", "remat"])
def test_pipelined_gradients(runs, remat):
    """The gradients of mean(out²) through the pipeline at pp 2 (the
    schedule's reverse ticks; non-block gradients summed over the stages),
    with and without remat: every parameter's against the one-process port
    (1e-6) and JAX's ``jax.grad`` of its pipelined forward (1e-4)."""
    name = f"grad_remat{remat}"
    got = runs["fwd"][name]["grads"]
    _dicts_close(got, runs["port_fwd"][name][1], 1e-6, "one process")
    _dicts_close(got, runs["jax_fwd"][name][1], 1e-4, "jax")
    assert rel_l2(runs["fwd"][name]["out"], runs["jax_fwd"][name][0]) <= 1e-4


def _metric_close(got, want, rel, keys):
    for g, w in zip(got, want):
        for k in keys:
            assert abs(g[k] - w[k]) <= rel * max(abs(w[k]), 1e-12), (k, g[k], w[k])


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_train_step_matches_one_process_and_jax(runs, case):
    """Two steps through the pipelined apply at dp 2 x pp 2 and pp 4, with
    and without zero1: losses and grad norms, every parameter and EMA entry
    (blocks and the replicated ones) against the one-process port (1e-6) and
    JAX's pipelined step on a (dp 2, pp 2) mesh (loss 1e-5, the rest 1e-4);
    the full optimizer state in the one-process layout."""
    got = runs["step"][case[0]]
    want_metrics, want_params, want_ema = runs["port_step"]
    _metric_close(got["metrics"], want_metrics, 1e-6, ["loss", "grad_norm", "mse", "vb"])
    _dicts_close(got["model"], want_params, 1e-6, "params")
    _dicts_close(got["ema"], want_ema, 1e-6, "ema")
    jm, jp, je = runs["jax_step"]
    _metric_close(got["metrics"], jm, 1e-5, ["loss"])
    _metric_close(got["metrics"], jm, 1e-4, ["grad_norm"])
    _dicts_close(got["model"], jp, 1e-4, "jax params")
    _dicts_close(got["ema"], je, 1e-4, "jax ema")
    opt = got["opt"]
    assert opt["param_groups"][0]["params"] == list(range(len(want_params)))
    assert len(opt["state"]) == len(want_params) and float(opt["state"][0]["step"]) == 2


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_each_rank_holds_its_stage_blocks(runs, case):
    """A rank's block parameters are 1/S of the model's (pp exists to hold
    them so); dp replicas hold the same."""
    got = runs["step"][case[0]]
    whole = sum(v.numel() for k, v in runs["port_step"][1].items() if k.startswith("blocks."))
    assert got["blocks"] == [whole // case[1]] * 4


def test_train_main_checkpoint_matches_one_process(runs):
    """``train.main`` at pipeline_parallel=2 (2 steps, pp_microbatches 2,
    from randomized ``pretrained`` weights): the logged losses and grad
    norms of one process, and rank 0's checkpoint, in the one-process
    layout, equal to one process's step-2 checkpoint: model, EMA and the
    optimizer's moments (1e-6)."""
    got = runs["train"]["pp2"]
    _metric_close(got["metrics"], runs["one"]["train"][:2], 1e-6, ["loss", "grad_norm"])
    a = torch.load(glob.glob(f"{runs['tmp']}/pp2/*/checkpoints/0000002.pt")[0], weights_only=False)
    b = torch.load(glob.glob(f"{runs['tmp']}/one/*/checkpoints/0000002.pt")[0], weights_only=False)
    assert list(a["model"]) == list(b["model"]) and a["step"] == b["step"] == 2
    for which in ("model", "ema"):
        _dicts_close(a[which], b[which], 1e-6, which)
    assert a["opt"]["param_groups"][0]["params"] == b["opt"]["param_groups"][0]["params"]
    names = list(b["model"])
    for key in ("exp_avg", "exp_avg_sq"):
        _dicts_close({names[i]: s[key] for i, s in a["opt"]["state"].items()},
                     {names[i]: s[key] for i, s in b["opt"]["state"].items()}, 1e-6, key)


def test_train_main_latte_img_dp2_pp2_zero1(runs):
    """``train.main`` on ffs_img_train.yaml (LatteIMG, 4 video frames and 2
    stills, the tiny size) at dp 2 x pp 2 with zero1, 2 rows a rank: the
    logged losses and grad norms of one process on the global batch of 4
    (1e-6)."""
    got = runs["train"]["img"]
    assert got["result"]["final_step"] == 2
    _metric_close(got["metrics"], runs["one"]["img"], 1e-6, ["loss", "grad_norm"])


def test_resume_from_a_one_process_checkpoint(runs):
    """One process's step-2 checkpoint resumed at pipeline_parallel=2: each
    stage takes its pairs, EMA and moments, and step 3 logs one process's
    loss and grad norm (1e-6)."""
    got = runs["train"]["resume"]
    assert [m["step"] for m in got["metrics"]] == [3] and got["result"]["final_step"] == 3
    _metric_close(got["metrics"], runs["one"]["train"][2:], 1e-6, ["loss", "grad_norm"])


def test_moe_aux_weight_is_dropped_with_the_warning(runs):
    """An MoE model at pipeline_parallel=2 trains without the Switch loss,
    with the JAX trainer's warning in rank 0's log."""
    got = runs["train"]["moe"]
    assert got["result"]["final_step"] == 1 and np.isfinite(got["metrics"][0]["loss"])
    assert "moe_aux" not in got["metrics"][0] and got["experts"] == 2
    log = open(os.path.join(got["result"]["experiment_dir"], "log.txt")).read()
    assert train.PP_MOE_AUX_WARNING.format(0.01) in log


def test_sample_t2x_matches_one_process_and_jax(runs):
    """``sample_t2x`` at pipeline_parallel=2 (DDIM-2, CFG, the caption stub,
    a checkpoint of JAX parameters): every rank holds the latents of one
    process (1e-6) and of JAX's ``LattePipeline(pp_mesh=)`` with the same z
    (``close``); rank 0 alone wrote the output."""
    rank0, rank1 = runs["t2x"]
    close(rank0[0]["latents"], runs["one"]["t2x"], 1e-6, 1e-6)
    close(rank1[0]["latents"], runs["one"]["t2x"], 1e-6, 1e-6)
    close(rank0[0]["latents"], runs["jax_t2x"])
    assert os.path.exists(rank0[0]["path"]) and rank1[0]["path"] is None
    assert np.abs(runs["jax_t2x"]).max() > 0.1


# -- in one process -------------------------------------------------------------

def _units(n, d=8, seed=0):
    torch.manual_seed(seed)
    units = [torch.nn.Linear(d, d) for _ in range(n)]
    with torch.no_grad():
        for u in units:
            u.weight.mul_(0.3 * d**0.5)
    return units


def _stage_fn(stage_units, carry, offset):
    (x,) = carry
    for u in stage_units:
        x = torch.tanh(u(x))
    return (x,)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("M", [1, 2, 4])
def test_gpipe_matches_sequential(S, M):
    """The schedule over S virtual stages and M microbatches against the
    units applied in turn: the output, and the gradients of the units (in
    their ``.grad``, where the reverse schedule leaves them) and of the
    input (within 1e-6 of the largest magnitude)."""
    units = _units(4)
    params = [p for u in units for p in u.parameters()]
    x = torch.randn(8, 3, 8, requires_grad=True)
    want = x
    for u in units:
        want = torch.tanh(u(want))
    g = torch.randn_like(want)
    want_grads = torch.autograd.grad(want, [x, *params], g)
    xs = x.detach().clone().requires_grad_()
    (got,) = gpipe(_stage_fn, units, (xs,), M, LocalHop(S))
    got.backward(g)
    got_grads = [xs.grad, *[p.grad for p in params]]
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    for a, b in zip(got_grads, want_grads):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


def test_unit_offset_reaches_stages():
    """Each stage sees its first unit's absolute index and its own units:
    stage 0 adds 0 + 1, stage 1 adds 2 + 3 (tests/test_pipeline.py:78)."""
    def stage_fn(stage_units, carry, offset):
        assert stage_units == list(range(offset, offset + len(stage_units)))
        return (carry[0] + sum(offset + i for i in range(len(stage_units))),)

    (out,) = gpipe(stage_fn, list(range(4)), (torch.zeros(2, 3, 1),), 2, LocalHop(2))
    assert torch.equal(out, torch.full((2, 3, 1), 6.0))


def test_virtual_pipeline_train_step_matches_one_model():
    """chip_smoke.py's phase "pp one card" at a tiny size: one train step of
    a Latte through the virtual pipeline (4 stages, 4 microbatches) against
    the one-model step from the same weights, generator and batch: loss and
    grad norm within 1e-6, every parameter after the update within 1e-6
    (the k part of each qkv bias left out)."""
    torch.manual_seed(0)

    def state():
        model = Latte(**STEP, extras=2, num_classes=10)
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for p in model.parameters():
                p.normal_(0, 0.1, generator=gen)
        return model, create_train_state(model, make_optimizer(model, 0.01), make_lr_schedule(1e-3))

    batch = {"latents": torch.randn(4, 4, 4, 4, 4), "y": torch.tensor([1, 2, 3, 4])}
    results = []
    for virtual in (False, True):
        model, st = state()
        apply_fn = make_pipelined_apply(model, 4, 4) if virtual else None
        step = make_train_step(create_diffusion(""), apply_fn=apply_fn, **HP)
        m = step(st, batch, torch.Generator().manual_seed(5))
        results.append(({k: float(v) for k, v in m.items()}, model.state_dict()))
    (got, got_sd), (want, want_sd) = results[1], results[0]
    _metric_close([got], [want], 1e-6, ["loss", "grad_norm"])
    _dicts_close(got_sd, want_sd, 1e-6, "params")


def test_pipelined_apply_refuses_other_conditioning():
    """The pipelined apply carries the Latte/LatteIMG conditioning alone, as
    the JAX adapter (``return_aux`` of the MoE step among the rest); a batch
    the microbatches do not divide raises the JAX text."""
    model = Latte(**STEP)
    apply_fn = make_pipelined_apply(model, 2, 2)
    x, t = torch.randn(3, 4, 4, 4, 4), torch.tensor([1, 2, 3])
    with pytest.raises(NotImplementedError, match="got extra kwargs \\['return_aux'\\]"):
        apply_fn(x, t, return_aux=True)
    with pytest.raises(AssertionError, match="batch 3 not divisible by microbatches 2"):
        pipelined_latte_forward(model, x, t, mesh=2, microbatches=2)
    with pytest.raises(AssertionError, match="4 units not divisible by pp=3"):
        Latte(**STEP, pp=3, pp_rank=0)
    with pytest.raises(IndexError, match="lives on another pipeline stage"):
        Latte(**STEP, pp=2, pp_rank=1)(x, t)


@pytest.mark.parametrize("override, world, error, match", [
    ("pipeline_parallel=2 expert_parallel=2 moe_experts=2", 4, ValueError,
     "expert_parallel does not compose with pipeline_parallel"),
    ("pipeline_parallel=2 sequence_parallel=2", 4, ValueError, "composes with data parallelism only"),
    ("pipeline_parallel=2", 4, AssertionError, r"per-forward batch 10 \(global 10 / grad_accum 1\) not divisible "
                                               r"by pp_microbatches=4"),
    ("pipeline_parallel=2 pp_microbatches=5 gradient_accumulation_steps=5", 4, AssertionError,
     r"per-forward batch 2 \(global 10 / grad_accum 5\) not divisible by pp_microbatches=5"),
    ("pipeline_parallel=2 local_batch_size=5 pp_microbatches=2", 8, AssertionError,
     r"a rank's per-forward rows 5 .* not divisible by pp_microbatches=2"),
    ("pipeline_parallel=3", 4, AssertionError, "pipeline_parallel=3 x expert_parallel=1 must divide 4 devices"),
], ids=["ep", "sp", "microbatches", "accum", "rank_rows", "mesh"])
def test_trainer_refusals(override, world, error, match):
    """The JAX trainer's pipeline errors (ffs_train.yaml's batch of 5: at dp
    2 x pp 2 the global 10 that the default M = 4 does not divide), and the
    port's own for a rank's rows, before any process group."""
    with pytest.raises(error, match=match):
        train.check_config(load_config(FFS_TRAIN, override.split()), world)
    train.check_config(load_config(FFS_TRAIN, ["pipeline_parallel=2", "pp_microbatches=5"]), 4)
    assert train.pp_microbatches(load_config(FFS_TRAIN, ["pipeline_parallel=7"])) == 14
