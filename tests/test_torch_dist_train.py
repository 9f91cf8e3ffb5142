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
  concatenated shards' z.
"""

import os

import jax
import numpy as np
import pytest
import torch
from test_torch_dist_step import MOE, TINY, TS, _jax_run, _params, _port_run, _sd
from test_torch_train_step import _jax_noise
from torch_dist_util import Record, jobs, one_thread, resume_run, sample_run, spawn, step_cases, train_run, wait

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
ARCH = ["image_size=32", "num_frames=4", "model_overrides={depth: 2, hidden_size: 144, num_heads: 2}"]
TRAIN = ARCH + ["log_every=1", "learning_rate=1e-3", "max_train_steps=3", "ckpt_every=2"]
SAMPLE = ARCH + ["use_fp16=false", "sample_method=ddpm", "num_sampling_steps=3", "num_fvd_samples=4",
                 "per_proc_batch_size=1"]
SAMPLERS = {"ffs": (os.path.join(CONFIGS, "ffs", "ffs_sample.yaml"), ["create_npz=true"]),
            "ucf101": (os.path.join(CONFIGS, "ucf101", "ucf101_sample.yaml"), ["cfg_scale=4.0"])}
ACCUM = TRAIN + ["gradient_accumulation_steps=2", "schedule_sampler=loss-second-moment"]
CASES = [
    ("dp2", TINY, 1, False, False),
    ("dp1_ep2", MOE, 2, False, False),
    ("zero1_dp2", TINY, 1, False, True),
    ("fsdp_dp2", TINY, 1, True, False),
]


def _one_process_samples(cfg, out):
    """The port's sample loop in one process on the concatenated shards' z
    (shard s of iteration it from ``stream_seed(seed, 0, it·2 + s)``), the
    labels and DDPM's noise drawn for the global batch, as sample_many at
    world 2 names its files (index it·2 + s)."""
    model = sample.build_model(cfg, torch.device("cpu"))
    shape = sample.latent_shape(cfg, 1)
    gen = lambda stream, i: torch.Generator().manual_seed(sample_many.stream_seed(0, stream, i))  # noqa: E731
    os.makedirs(out)
    for it in range(2):
        z = torch.cat([torch.randn(shape, generator=gen(sample_many.Z_STREAM, it * 2 + s)) for s in range(2)])
        y = None
        if int(cfg.extras) == 2:
            y = torch.randint(0, model.num_classes, (2,), generator=gen(sample_many.LABEL_STREAM, it))
        latents = sample.sample_loop(model, cfg, z, y, gen(sample_many.NOISE_STREAM, it))
        for s in range(2):
            np.savez(out / f"{it * 2 + s:04d}.npz", latents=latents[s].numpy())


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
    todo = [(step_cases, (path, CASES)),
            (train_run, (FFS_TRAIN, TRAIN + ["local_batch_size=1", f"results_dir={tmp}/results"], str(tmp / "train"))),
            (resume_run, (FFS_TRAIN, TRAIN + ["local_batch_size=1", "fsdp=true", f"results_dir={tmp}/fsdp"],
                          str(tmp / "results"), str(tmp / "fsdp"))),
            (train_run, (FFS_TRAIN, ACCUM + ["local_batch_size=2", f"results_dir={tmp}/accum"], str(tmp / "accum"))),
            (train_run, (UCF_TRAIN, TRAIN + ["local_batch_size=1", f"results_dir={tmp}/ucf"], str(tmp / "ucf")))]
    todo += [(sample_run, (cfg, SAMPLE + extra + [f"save_video_path={tmp}/{name}2"]))
             for name, (cfg, extra) in SAMPLERS.items()]
    ranks = spawn(jobs, WORLD, todo, join=False)
    ref = {0: (params[0], *_jax_run(TINY, params[0], x0))}
    accum, ucf = Record(), Record()
    with one_thread():
        port = {e: _port_run(kw, weights[e], batches) for e, kw in ((0, TINY), (4, MOE))}
        for name, (cfg, extra) in SAMPLERS.items():
            _one_process_samples(load_config(cfg, SAMPLE + extra), tmp / f"{name}1")
        train.main(load_config(FFS_TRAIN, ACCUM + ["local_batch_size=4", f"results_dir={tmp}/accum1"]),
                   callbacks=[accum], device="cpu")
        train.main(load_config(UCF_TRAIN, TRAIN + ["local_batch_size=2", f"results_dir={tmp}/ucf1"]),
                   callbacks=[ucf], device="cpu")
    wait(ranks)
    return {"tmp": tmp, "got": torch.load(path + ".out", weights_only=False), "jax": ref, "port": port,
            "train": [torch.load(f"{tmp}/train.{r}", weights_only=False) for r in range(WORLD)],
            "fsdp": [torch.load(f"{tmp}/fsdp.{r}", weights_only=False) for r in range(WORLD)],
            "accum": [torch.load(f"{tmp}/accum.{r}", weights_only=False) for r in range(WORLD)],
            "accum1": accum.metrics,
            "ucf": [torch.load(f"{tmp}/ucf.{r}", weights_only=False) for r in range(WORLD)], "ucf1": ucf.metrics}


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
    resumes from step 2 to the unbroken run's step-3 loss."""
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
    for got in [rec.metrics] + [r["metrics"] for r in runs["fsdp"]]:
        assert [m["step"] for m in got] == [3]
        for k in ("loss", "grad_norm"):
            assert abs(got[0][k] - want[k]) <= 1e-6 * abs(want[k]), (k, got[0][k], want[k])


@pytest.mark.parametrize("run", ["accum", "ucf"])
def test_draws_on_two_ranks_match_one_process(runs, run):
    """Two chunks a step with the loss-aware sampler (``accum``), and the
    class labels' dropout of ``ucf101_train.yaml`` (``ucf``), at world 2
    are the one-process run on the same global batch."""
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


@pytest.mark.parametrize("override, world, error, match", [
    ("tensor_parallel=2", 2, NotImplementedError, r"tensor_parallel=2: not ported yet; comes with the multi-GPU "
                                                  r"slice's second half \(ROADMAP M6b\)"),
    ("sequence_parallel=2", 2, NotImplementedError, r"sequence_parallel=2: .*ROADMAP M6b"),
    ("pipeline_parallel=2", 2, NotImplementedError, r"pipeline_parallel=2: .*ROADMAP M6b"),
    ("expert_parallel=4", 2, AssertionError, "expert_parallel=4 must divide 2 devices"),
    ("expert_parallel=4", 6, AssertionError, "expert_parallel=4 must divide 6 devices"),
    ("zero1=true", 4, ValueError, "zero1 \\+ expert_parallel: use fsdp instead"),
    ("moe_experts=6", 4, ValueError, "expert_parallel=4 needs moe_experts \\(got 6\\) divisible by it"),
], ids=["tp", "sp", "pp", "mesh2", "mesh6", "zero1_ep", "experts"])
def test_refusals(override, world, error, match):
    """What the trainer refuses at a world size, before any process group:
    the M6b axes, and the JAX trainer's errors for a mesh that does not
    divide the world, zero1 with expert parallelism and experts that ep
    does not divide (the shipped MoE config, ``expert_parallel: 4``)."""
    with pytest.raises(error, match=match):
        train.check_config(load_config(FFS_MOE, [override]), world)
    with pytest.raises(AssertionError, match="mesh dp1xep4xsp1xtp1xpp1 != 6 devices"):
        MeshConfig(dp=1, ep=4).resolve(6)
    train.check_config(load_config(FFS_MOE, []), 4)
    train.check_config(load_config(FFS_MOE, ["fsdp=true", "zero1=true"]), 8)


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
