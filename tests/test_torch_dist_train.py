"""The port's trainer and FVD sampler over two processes (gloo on the CPU),
and what the multi-GPU keys refuse.

One spawn of 2 ranks (module fixture) runs:

- two steps of ``make_train_step`` for dp 2, zero1 and fsdp at dp 2, held
  to the JAX step and the one-process port on the same global batch of 4
  as tests/test_torch_dist_step.py holds its four-rank cases (same
  tolerances), and dp 1 x ep 2 (4 experts) to the one-process port (the
  four-rank file holds ep against the JAX step);
- ``train.main`` on ``configs/ffs/ffs_train.yaml`` at the tiny size (depth 2,
  hidden 144, 2 heads, 4 frames of 32x32, global batch 2) for 3 steps with a
  checkpoint at step 2: one experiment directory, log lines from rank 0
  alone, equal losses on both ranks; the step-2 checkpoint loads into the
  one-process sampler and resumes at world 1 (global batch 2 in one process)
  to the unbroken run's step-3 loss within 1e-6, and so does a world-2 run
  under ``fsdp`` (each rank cutting its shards from the full state);
- ``train.main`` at global batch 4 with ``gradient_accumulation_steps: 2``
  and the loss-aware timestep sampler (``loss-second-moment``: t drawn for
  the global batch, its update fed the all-gathered t and losses) against
  one process at the same global batch: losses and grad norms within 1e-6,
  and so for ``ucf101_train.yaml`` (the class labels' dropout drawn for the
  global batch);
- ``sample_many`` (DDPM, 3 steps, 4 videos, one a rank an iteration) on
  ``ffs_sample.yaml`` and, with labels and guidance, ``ucf101_sample.yaml``
  at ``cfg_scale`` 4: its latents equal, to the bit, one process's on the
  concatenated shards' z; and so for an MoE model (4 experts, top-2,
  capacity factor 1.0, from a randomized checkpoint, MOE_BATCH videos a
  rank: one dispatch group spans both ranks' tokens, and under CFG the
  [cond | uncond] halves of the global batch);
- ``train.main`` from randomized ``pretrained`` weights with
  ``tensor_parallel=2``, with ``sequence_parallel=2``, with tp 2 under
  ``quant_train`` and on LatteIMG with tp 2 (global batch 2), and with the
  loss-aware timestep sampler past its warm-up (``warm_sampler``: its
  history full from a seed) at global batch 4 with 2 chunks a step, each
  against one process within 1e-6 (``quant_train`` 1e-3); a tp 2 run
  resumes from the dp run's checkpoint and in one process from its own;
- ``sample.main`` with ``tensor_parallel=2`` (DDIM-3 from a randomized
  checkpoint, 3 block pairs of 2 heads) against the JAX sampler at
  ``tensor_parallel: 2`` on two virtual CPU devices, same weights and z:
  unconditional (``y = None``), class-conditional with CFG, the block cache
  at interval 2, static W8A8 with int8 attention and dynamic W8A8 (whose
  per-token amax of the row-parallel layers is all-reduced over tp), within
  tests/test_torch_sample.py's tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dist_step import MOE, TINY, TS, _jax_run, _params, _port_run, _sd
from test_torch_train_step import _jax_noise
from torch_dist_util import (
    Record,
    jobs,
    one_thread,
    resume_run,
    sample_main_run,
    sample_run,
    spawn,
    step_cases,
    train_run,
    wait,
    warm_sampler,
    warm_train_run,
)
from torch_port_util import close, randomize

from latte_tpu.config import load_config as jax_load_config
from latte_tpu.core.diffusion import create_diffusion as jax_create_diffusion
from latte_tpu.models import get_models as jax_get_models
from latte_tpu.quant import merge_amax
from latte_tpu.quant import quantize_params as jax_quantize_params
from latte_tpu.sample.sample import build_sample_fn
from latte_tpu_torch.convert import flax_to_state_dict
from latte_tpu_torch.models import get_models

from latte_tpu_torch.config import load_config
from latte_tpu_torch.dist.mesh import MeshConfig, initialize_distributed
from latte_tpu_torch.sample import sample, sample_many
from latte_tpu_torch.train import train
from latte_tpu_torch.train.checkpoint import load_checkpoint

WORLD = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
FFS_TRAIN = os.path.join(CONFIGS, "ffs", "ffs_train.yaml")
FFS_MOE = os.path.join(CONFIGS, "ffs", "ffs_train_moe.yaml")
UCF_TRAIN = os.path.join(CONFIGS, "ucf101", "ucf101_train.yaml")
FFS_IMG_TRAIN = os.path.join(CONFIGS, "ffs", "ffs_img_train.yaml")
ARCH = ["image_size=32", "num_frames=4", "model_overrides={depth: 2, hidden_size: 144, num_heads: 2}"]
TRAIN = ARCH + ["log_every=1", "learning_rate=1e-3", "max_train_steps=3", "ckpt_every=2"]
SAMPLE = ARCH + ["use_fp16=false", "sample_method=ddpm", "num_sampling_steps=3", "num_fvd_samples=4",
                 "per_proc_batch_size=1"]
SAMPLERS = {"ffs": (os.path.join(CONFIGS, "ffs", "ffs_sample.yaml"), ["create_npz=true"]),
            "ucf101": (os.path.join(CONFIGS, "ucf101", "ucf101_sample.yaml"), ["cfg_scale=4.0"])}
ACCUM = TRAIN + ["gradient_accumulation_steps=2", "schedule_sampler=loss-second-moment"]
# LatteIMG (2 still images behind the 4 frames) at global batch 2
IMG = TRAIN + ["local_batch_size=2", "use_image_num=2"]
MOE_SAMPLE = ["moe_experts=4", "moe_top_k=2", "moe_capacity_factor=1.0"]
# videos a rank in the MoE runs: each rank's forward takes 2 rows (CFG
# doubles ucf101's one) against one process's 4. Bits hold across a split of
# the batch only where the CPU's BLAS takes the same kernels for both
# sizes: at 1 row a rank's products take the matrix-vector route, which sums
# in another order than one process's 2-row product (2.4e-7 apart at the
# timestep embedder's first layer of a dense model), and 4 rows against 8
# differ likewise at this width; 2 against 4 agree to the bit
MOE_BATCH = {"ffs": 2, "ucf101": 1}
# tensor-parallel serving at tp 2: 3 block pairs of 2 heads, DDIM-3
TP_SAMPLE = ["model_overrides={depth: 6, hidden_size: 32, num_heads: 2}", "image_size=32", "num_frames=2",
             "use_fp16=false", "sample_method=ddim", "num_sampling_steps=3", "tensor_parallel=2"]
TP_CASES = {
    "uncond": [],
    "cfg": ["extras=2", "num_classes=10", "cfg_scale=4.0", "sample_class=3"],
    "block_cache": ["block_cache_interval=2"],
    "int8_static": ["quantized=static", "attention_mode=flash", "int8_attention=true"],
    "int8_dynamic": ["quantized=true"],
}
CASES = [
    ("dp2", TINY, 1, False, False),
    ("dp1_ep2", MOE, 2, False, False),
    ("zero1_dp2", TINY, 1, False, True),
    ("fsdp_dp2", TINY, 1, True, False),
]


def _one_process_samples(cfg, out):
    """The port's sample loop in one process on the concatenated shards' z
    (shard s of iteration it from ``stream_seed(seed, 0, it·2 + s)``,
    ``per_proc_batch_size`` videos), the labels and DDPM's noise drawn for
    the global batch, as sample_many at world 2 names its files (row p of
    shard s: index it·global + p·2 + s)."""
    model = sample.build_model(cfg, torch.device("cpu"))
    per = int(cfg.per_proc_batch_size)
    shape = sample.latent_shape(cfg, per)
    gen = lambda stream, i: torch.Generator().manual_seed(sample_many.stream_seed(0, stream, i))  # noqa: E731
    os.makedirs(out)
    for it in range(4 // (2 * per)):
        z = torch.cat([torch.randn(shape, generator=gen(sample_many.Z_STREAM, it * 2 + s)) for s in range(2)])
        y = None
        if int(cfg.extras) == 2:
            y = torch.randint(0, model.num_classes, (2 * per,), generator=gen(sample_many.LABEL_STREAM, it))
        latents = sample.sample_loop(model, cfg, z, y, gen(sample_many.NOISE_STREAM, it))
        for b in range(2 * per):
            s, p = divmod(b, per)
            np.savez(out / f"{it * 2 * per + p * 2 + s:04d}.npz", latents=latents[b].numpy())


def _tp_sampler_ckpt(tmp, name):
    """A TP_CASES case's checkpoint, from JAX params randomized from a
    seed; returns its path and the params."""
    jcfg = jax_load_config(SAMPLERS["ffs"][0], TP_SAMPLE + TP_CASES[name])
    jm = jax_get_models(jcfg)
    x0, t0 = jnp.zeros((1, 2, 4, 4, 4)), jnp.zeros((1,), jnp.int32)
    if int(getattr(jcfg, "extras", 1)) == 2:
        rngs = {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)}
        params = jm.init(rngs, x0, t0, y=jnp.zeros((1,), jnp.int32))["params"]
    else:
        params = jm.init(jax.random.PRNGKey(0), x0, t0)["params"]
    params = randomize(params, seed=3, std=0.1)
    ckpt = str(tmp / f"tp_{name}.pt")
    torch.save({"ema": flax_to_state_dict(params, 6, 2, 2)}, ckpt)
    return ckpt, params


def _jax_tp_sampler(name, params):
    """The JAX sampler's latents at tensor_parallel 2 (its Megatron split
    over two virtual CPU devices) for a TP_CASES case, with the JAX
    sampler's int8 recipe (the calibration on the port's calibration z, as
    tests/test_torch_sample.py does)."""
    over = TP_SAMPLE + TP_CASES[name]
    cfg, jcfg = load_config(SAMPLERS["ffs"][0], over), jax_load_config(SAMPLERS["ffs"][0], over)
    extras = int(getattr(cfg, "extras", 1))
    jm = jax_get_models(jcfg)
    if name == "int8_static":
        zc = jnp.asarray(sample.calibration_latents(cfg, torch.device("cpu")).numpy())
        calib = jm.clone(quantized="calib")
        amax = None
        for tc in sample.CALIBRATION_TIMESTEPS:
            _, var = calib.apply({"params": params}, zc, jnp.full((1,), tc, jnp.int32), mutable=["calib"])
            amax = merge_amax(amax, var["calib"])
        jm, params = jm.clone(quantized="static"), jax_quantize_params(params, act_amax=amax)
    elif name == "int8_dynamic":
        jm, params = jm.clone(quantized=True), jax_quantize_params(params)
    fn, use_cfg = build_sample_fn(jm, {"params": params}, jcfg, jax_create_diffusion("3"))
    assert fn.tp_mesh.shape["tp"] == 2  # the JAX sampler split the model
    z = jnp.asarray(torch.randn((1, 2, 4, 4, 4), generator=torch.Generator().manual_seed(0)).numpy())
    y = None
    if extras == 2:
        y = jnp.array([3], jnp.int32)
        if use_cfg:
            z, y = jnp.concatenate([z, z]), jnp.array([3, 10], jnp.int32)
    return np.asarray(fn(z, y, jax.random.PRNGKey(1)))[:1]


def _pretrained(tmp) -> str:
    """``pretrained=`` a checkpoint of TRAIN's model with every weight
    N(0, 0.1²) from a seed (the reference init's zero adaLN gates would
    leave the blocks out of the first step's loss)."""
    model = get_models(load_config(FFS_TRAIN, TRAIN))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.1, generator=gen)
    torch.save({"ema": model.state_dict()}, tmp / "pretrained.pt")
    return f"pretrained={tmp / 'pretrained.pt'}"


def _moe_ckpt(tmp, name):
    """A randomized checkpoint of the MoE sampler's model (the adaLN and
    output layers carry signal, so the experts' outputs reach the latents)."""
    cfg_path, extra = SAMPLERS[name]
    model = sample.build_model(load_config(cfg_path, SAMPLE + extra + MOE_SAMPLE), torch.device("cpu"))
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.1, generator=gen)
    path = str(tmp / f"moe_{name}.pt")
    torch.save({"ema": model.state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 4, 4, 4, 4)).astype(np.float32)
    params = {0: _params(TINY, x0), 4: _params(MOE, x0)}
    weights = {e: _sd(p) for e, p in params.items()}
    noises = [_jax_noise(jax.random.PRNGKey(7), s, x0.shape) for s in range(len(TS))]
    batches = [{"latents": torch.from_numpy(x0), "t": torch.from_numpy(t), "noise": torch.from_numpy(n.copy())}
               for t, n in zip(TS, noises)]
    path = str(tmp / "data.pt")
    torch.save({"weights": weights, "batches": batches}, path)
    moe_ckpts = {name: _moe_ckpt(tmp, name) for name in SAMPLERS}
    tp_ckpts = {name: _tp_sampler_ckpt(tmp, name) for name in TP_CASES}
    todo = [(step_cases, (path, CASES)),
            (train_run, (FFS_TRAIN, TRAIN + ["local_batch_size=1", f"results_dir={tmp}/results"], str(tmp / "train"))),
            (resume_run, (FFS_TRAIN, TRAIN + ["local_batch_size=1", "fsdp=true", f"results_dir={tmp}/fsdp"],
                          str(tmp / "results"), str(tmp / "fsdp"))),
            (train_run, (FFS_TRAIN, ACCUM + ["local_batch_size=2", f"results_dir={tmp}/accum"], str(tmp / "accum"))),
            (warm_train_run, (FFS_TRAIN, ACCUM + ["local_batch_size=2", f"results_dir={tmp}/warm"],
                              str(tmp / "warm"))),
            (train_run, (UCF_TRAIN, TRAIN + ["local_batch_size=1", f"results_dir={tmp}/ucf"], str(tmp / "ucf")))]
    pre = _pretrained(tmp)
    todo += [(train_run, (FFS_TRAIN, TRAIN + ["local_batch_size=2", f"{key}=2", pre, f"results_dir={tmp}/{key}"],
                          str(tmp / key))) for key in ("tensor_parallel", "sequence_parallel")]
    todo += [(train_run, (FFS_TRAIN, TRAIN + ["local_batch_size=2", "tensor_parallel=2", "quant_train=true", pre,
                                              f"results_dir={tmp}/quant_train"], str(tmp / "quant_train"))),
             (train_run, (FFS_IMG_TRAIN, IMG + ["tensor_parallel=2", pre, f"results_dir={tmp}/img"], str(tmp / "img"))),
             # the dp run's step-2 checkpoint (one-process format) cut into tp shards
             (resume_run, (FFS_TRAIN, TRAIN + ["local_batch_size=2", "tensor_parallel=2",
                                               f"results_dir={tmp}/tp_resume"], str(tmp / "results"),
                           str(tmp / "tp_resume")))]
    todo += [(sample_run, (cfg, SAMPLE + extra + [f"save_video_path={tmp}/{name}2"]))
             for name, (cfg, extra) in SAMPLERS.items()]
    todo += [(sample_run, (cfg, SAMPLE + extra + MOE_SAMPLE + [
        f"ckpt={moe_ckpts[name]}", f"per_proc_batch_size={MOE_BATCH[name]}", f"save_video_path={tmp}/moe_{name}2"]))
        for name, (cfg, extra) in SAMPLERS.items()]
    todo += [(sample_main_run, (SAMPLERS["ffs"][0], TP_SAMPLE + TP_CASES[name] + [
        f"ckpt={tp_ckpts[name][0]}", f"save_video_path={tmp}/tp_{name}/v.mp4"])) for name in TP_CASES]
    ranks = spawn(jobs, WORLD, todo, join=False)
    ref = {0: (params[0], *_jax_run(TINY, params[0], x0))}
    jax_tp = {name: _jax_tp_sampler(name, tp_ckpts[name][1]) for name in TP_CASES}
    accum, ucf, warm, one_b2, img, qat = Record(), Record(), Record(), Record(), Record(), Record()
    with one_thread():
        port = {e: _port_run(kw, weights[e], batches) for e, kw in ((0, TINY), (4, MOE))}
        for name, (cfg, extra) in SAMPLERS.items():
            _one_process_samples(load_config(cfg, SAMPLE + extra), tmp / f"{name}1")
            _one_process_samples(load_config(cfg, SAMPLE + extra + MOE_SAMPLE + [
                f"ckpt={moe_ckpts[name]}", f"per_proc_batch_size={MOE_BATCH[name]}"]), tmp / f"moe_{name}1")
        train.main(load_config(FFS_TRAIN, ACCUM + ["local_batch_size=4", f"results_dir={tmp}/accum1"]),
                   callbacks=[accum], device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(train, "create_named_schedule_sampler", warm_sampler)
            train.main(load_config(FFS_TRAIN, ACCUM + ["local_batch_size=4", f"results_dir={tmp}/warm1"]),
                       callbacks=[warm], device="cpu")
        train.main(load_config(UCF_TRAIN, TRAIN + ["local_batch_size=2", f"results_dir={tmp}/ucf1"]),
                   callbacks=[ucf], device="cpu")
        train.main(load_config(FFS_TRAIN, TRAIN + ["local_batch_size=2", pre, f"results_dir={tmp}/b2"]),
                   callbacks=[one_b2], device="cpu")
        train.main(load_config(FFS_TRAIN, TRAIN + ["local_batch_size=2", "quant_train=true", pre,
                                                   f"results_dir={tmp}/qat1"]), callbacks=[qat], device="cpu")
        train.main(load_config(FFS_IMG_TRAIN, IMG + [pre, f"results_dir={tmp}/img1"]), callbacks=[img], device="cpu")
    wait(ranks)
    return {"tmp": tmp, "got": torch.load(path + ".out", weights_only=False), "jax": ref, "port": port,
            "train": [torch.load(f"{tmp}/train.{r}", weights_only=False) for r in range(WORLD)],
            "fsdp": [torch.load(f"{tmp}/fsdp.{r}", weights_only=False) for r in range(WORLD)],
            "accum": [torch.load(f"{tmp}/accum.{r}", weights_only=False) for r in range(WORLD)],
            "accum1": accum.metrics,
            "warm": [torch.load(f"{tmp}/warm.{r}", weights_only=False) for r in range(WORLD)], "warm1": warm.metrics,
            "ucf": [torch.load(f"{tmp}/ucf.{r}", weights_only=False) for r in range(WORLD)], "ucf1": ucf.metrics,
            "tensor_parallel": [torch.load(f"{tmp}/tensor_parallel.{r}", weights_only=False) for r in range(WORLD)],
            "sequence_parallel": [torch.load(f"{tmp}/sequence_parallel.{r}", weights_only=False)
                                  for r in range(WORLD)], "b2": one_b2.metrics,
            "img": [torch.load(f"{tmp}/img.{r}", weights_only=False) for r in range(WORLD)], "img1": img.metrics,
            "quant_train": [torch.load(f"{tmp}/quant_train.{r}", weights_only=False) for r in range(WORLD)],
            "quant_train1": qat.metrics,
            "tp_resume": [torch.load(f"{tmp}/tp_resume.{r}", weights_only=False) for r in range(WORLD)],
            "jax_tp": jax_tp}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_two_ranks_match_jax_and_one_process(runs, case):
    from test_torch_dist_step import test_step_matches_jax_on_the_global_batch, test_step_matches_one_process

    if not case[1].get("moe_experts"):
        test_step_matches_jax_on_the_global_batch(runs, case)
    test_step_matches_one_process(runs, case)


def test_train_main_on_two_ranks(runs):
    """One experiment directory (rank 0's, joined by rank 1), its log lines
    written once, and the same global-batch metrics on both ranks."""
    first, second = runs["train"]
    exp = first["result"]["experiment_dir"]
    assert second["result"]["experiment_dir"] == exp
    assert os.listdir(runs["tmp"] / "results") == [os.path.basename(exp)]
    log = open(os.path.join(exp, "log.txt")).read()
    assert "2 processes (gloo): dp 2 x ep 1, global batch 2" in log
    for step in (1, 2, 3):
        assert log.count(f"step {step}: loss=") == 1
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == ["0000002.pt", "0000003.pt"]
    assert len(first["metrics"]) == 3
    for a, b in zip(first["metrics"], second["metrics"]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"] and np.isfinite(a["loss"])


def test_checkpoint_feeds_the_sampler_and_resumes_in_one_process(runs, tmp_path):
    """The world-2 checkpoint is the one-process format: the one-process
    sampler loads its EMA, and a world-1 run at the same global batch
    resumes from step 2 to the unbroken run's step-3 loss, as do a world-2
    run under fsdp and one at tp 2 (each rank cutting its shards from the
    full state); and a tp 2 run's step-2 checkpoint resumes in one process
    to its own step 3."""
    first = runs["train"][0]
    ckpt_dir = os.path.join(first["result"]["experiment_dir"], "checkpoints")
    at_two = os.path.join(ckpt_dir, "0000002.pt")
    payload = load_checkpoint(at_two)
    assert payload["step"] == 2 and set(payload) == {"model", "ema", "opt", "step", "args"}

    scfg = load_config(SAMPLERS["ffs"][0], ARCH + ["use_fp16=false", "sample_method=ddim", "num_sampling_steps=2",
                                                   f"ckpt={at_two}", f"save_video_path={tmp_path}/v.mp4"])
    model = sample.build_model(scfg, torch.device("cpu"))
    for name, v in model.state_dict().items():
        assert torch.equal(v, payload["ema"][name]), name
    rec = Record()
    cfg = load_config(FFS_TRAIN, TRAIN + ["local_batch_size=2", f"results_dir={tmp_path}/r",
                                          f"resume_from_checkpoint={at_two}"])
    with one_thread():
        assert np.isfinite(np.load(sample.main(scfg, device="cpu"))["latents"]).all()
        out = train.main(cfg, callbacks=[rec], device="cpu")
    assert out["final_step"] == 3 and [m["step"] for m in rec.metrics] == [3]
    want = first["metrics"][2]
    # and the reverse way: a tp 2 run's step-2 checkpoint in one process
    tp_ckpt = os.path.join(runs["tensor_parallel"][0]["result"]["experiment_dir"], "checkpoints", "0000002.pt")
    tp_rec = Record()
    with one_thread():
        train.main(load_config(FFS_TRAIN, TRAIN + ["local_batch_size=2", f"results_dir={tmp_path}/tp",
                                                   f"resume_from_checkpoint={tp_ckpt}"]), callbacks=[tp_rec],
                   device="cpu")
    tp_want = runs["tensor_parallel"][0]["metrics"][2]
    for k in ("loss", "grad_norm"):
        assert abs(tp_rec.metrics[0][k] - tp_want[k]) <= 1e-6 * abs(tp_want[k]), (k, tp_rec.metrics, tp_want)
    for got in [rec.metrics] + [r["metrics"] for r in runs["fsdp"] + runs["tp_resume"]]:
        assert [m["step"] for m in got] == [3]
        for k in ("loss", "grad_norm"):
            assert abs(got[0][k] - want[k]) <= 1e-6 * abs(want[k]), (k, got[0][k], want[k])


@pytest.mark.parametrize("run", ["accum", "ucf", "warm"])
def test_draws_on_two_ranks_match_one_process(runs, run):
    """Two chunks a step with the loss-aware sampler (``accum``; ``warm``:
    past its warm-up, so t comes from the loss-weighted distribution, which
    each step's all-gathered losses move), and the class labels' dropout of
    ``ucf101_train.yaml`` (``ucf``), at world 2 are the one-process run on
    the same global batch."""
    want = runs[run + "1"]
    assert [m["step"] for m in want] == [1, 2, 3]
    for rank in runs[run]:
        for got, w in zip(rank["metrics"], want):
            for k in ("loss", "grad_norm"):
                assert abs(got[k] - w[k]) <= 1e-6 * abs(w[k]), (k, got[k], w[k])


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sample_many_on_two_ranks_writes_one_process_latents(runs, name):
    """Each rank writes its own indices; the files are one process's, to
    the bit."""
    two, one = runs["tmp"] / f"{name}2", runs["tmp"] / f"{name}1"
    files = sorted(os.listdir(one))
    bundle = ["samples_4.npz"] if "create_npz=true" in SAMPLERS[name][1] else []
    assert files == [f"{i:04d}.npz" for i in range(4)] and sorted(os.listdir(two)) == files + bundle
    for f in files:
        a, b = np.load(two / f)["latents"], np.load(one / f)["latents"]
        assert a.shape == (4, 4, 4, 4) and np.array_equal(a, b), f
    if bundle:  # rank 0's, after the barrier: every rank's files
        arr = np.load(two / bundle[0])["arr_0"]
        assert np.array_equal(arr, np.stack([np.load(one / f)["latents"] for f in files]))


@pytest.mark.parametrize("key", ["tensor_parallel", "sequence_parallel", "img", "quant_train"])
def test_tensor_and_sequence_parallel_train_on_two_ranks(runs, key):
    """``train.main`` from the same randomized ``pretrained`` weights on
    ffs_train.yaml at the tiny size with tp 2 (a head a rank), with sp 2 and
    with tp 2 under ``quant_train``, and on ffs_img_train.yaml (LatteIMG, 2
    still images) with tp 2, global batch 2: the one-process run's losses
    and grad norms within 1e-6, the same on both ranks. ``quant_train``
    within 1e-3 (test_torch_train_cli.py's bound against JAX, for the same
    reason: an fp32 activation an ulp from a rounding boundary of round(x /
    s), here out of row-parallel sums in another order, lands on the
    neighbouring int8 value; measured 8.8e-5 at step 3, its first step
    equal)."""
    want = runs[{"img": "img1", "quant_train": "quant_train1"}.get(key, "b2")]
    rel = 1e-3 if key == "quant_train" else 1e-6
    assert [m["step"] for m in want] == [1, 2, 3]
    for rank in runs[key]:
        assert rank["result"]["final_step"] == 3
        for got, w in zip(rank["metrics"], want):
            for k in ("loss", "grad_norm"):
                assert abs(got[k] - w[k]) <= rel * abs(w[k]), (key, k, got[k], w[k])


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tensor_parallel_sampler_matches_the_jax_sampler(runs, name):
    """``sample.main`` at tensor_parallel 2 against the JAX sampler at
    tensor_parallel 2 on the same weights and z: fp32 within 1e-5 relative
    L2 (1e-4 of the largest element), the int8 modes within 2e-2 (5e-2),
    tests/test_torch_sample.py's bounds."""
    got = np.load(runs["tmp"] / f"tp_{name}" / "v_latents.npz")["latents"]
    want = runs["jax_tp"][name]
    assert got.shape == (1, 2, 4, 4, 4) and np.isfinite(got).all()
    if name.startswith("int8"):
        close(got, want, 2e-2, 5e-2)
    else:
        close(got, want)


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_moe_sample_many_on_two_ranks_writes_one_process_latents(runs, name):
    """An MoE model's FVD folder at world 2 is one process's, to the bit."""
    two, one = runs["tmp"] / f"moe_{name}2", runs["tmp"] / f"moe_{name}1"
    files = sorted(os.listdir(one))
    assert files == [f"{i:04d}.npz" for i in range(4)] and set(files) <= set(os.listdir(two))
    for f in files:
        a, b = np.load(two / f)["latents"], np.load(one / f)["latents"]
        assert np.array_equal(a, b), f
    assert np.abs(np.load(one / files[0])["latents"]).max() > 0.1


@pytest.mark.parametrize("override, world, error, match", [
    ("tensor_parallel=2", 2, AssertionError, r"tensor_parallel=2 x sequence_parallel=1 x pipeline_parallel=1 x "
                                             r"expert_parallel=4 must divide 2 devices"),
    ("sequence_parallel=2", 2, AssertionError, r"sequence_parallel=2 x .* must divide 2 devices"),
    ("pipeline_parallel=2", 2, ValueError, "expert_parallel does not compose with pipeline_parallel"),
    ("expert_parallel=4", 2, AssertionError, "expert_parallel=4 must divide 2 devices"),
    ("expert_parallel=4", 6, AssertionError, "expert_parallel=4 must divide 6 devices"),
    ("zero1=true", 4, ValueError, "zero1 \\+ expert_parallel: use fsdp instead"),
    ("moe_experts=6", 4, ValueError, "expert_parallel=4 needs moe_experts \\(got 6\\) divisible by it"),
], ids=["tp", "sp", "pp", "mesh2", "mesh6", "zero1_ep", "experts"])
def test_refusals(override, world, error, match):
    """What the trainer refuses at a world size, before any process group:
    the JAX trainer's errors for pipeline parallelism with the shipped MoE
    config's ``expert_parallel: 4``, for a mesh
    that does not divide the world (the shipped MoE config's
    ``expert_parallel: 4`` times a tp or sp of 2 at world 2), zero1 with
    expert parallelism and experts that ep does not divide."""
    with pytest.raises(error, match=match):
        train.check_config(load_config(FFS_MOE, [override]), world)
    with pytest.raises(AssertionError, match="mesh dp1xep4xsp1xtp1xpp1 != 6 devices"):
        MeshConfig(dp=1, ep=4).resolve(6)
    train.check_config(load_config(FFS_MOE, []), 4)
    train.check_config(load_config(FFS_MOE, ["fsdp=true", "zero1=true"]), 8)
    train.check_config(load_config(FFS_MOE, ["tensor_parallel=2", "sequence_parallel=2"]), 16)


def test_no_gpu_without_cpu_raises(monkeypatch):
    """A rendezvous on a machine without a GPU raises unless the caller
    asked for the CPU: it never falls back to gloo on its own."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed("localhost:1", num_processes=2, process_id=1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("num_shards", [2, 4])
def test_loader_shards_are_disjoint_and_complete(num_shards):
    """The loader of dp index i reads the strided shard i of each epoch's
    order (``shard_id``/``num_shards``, as the JAX loader): the shards of
    one epoch are disjoint and cover the dataset, and a loader of the same
    dp index (an ep replica) reads the same rows."""
    from latte_tpu_torch.data import DataLoader

    dataset = [{"i": np.array(i)} for i in range(24)]

    def epoch(shard):
        it = iter(DataLoader(dataset, batch_size=1, num_workers=1, seed=5, shard_id=shard, num_shards=num_shards))
        return [int(next(it)["i"][0]) for _ in range(24 // num_shards)]

    shards = [epoch(s) for s in range(num_shards)]
    assert sorted(sum(shards, [])) == list(range(24))
    assert epoch(num_shards - 1) == shards[-1]
