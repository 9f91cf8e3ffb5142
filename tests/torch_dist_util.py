"""Helpers of the multi-process CPU tests (tests/test_torch_dist_*.py): one
``torch.multiprocessing`` spawn of W ranks over gloo, and what the ranks run.
The ranks import torch and the port alone (no JAX); what they bring back
goes through files under the test's temporary directory."""

from __future__ import annotations

import contextlib
import copy
import glob
import os
import socket
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from latte_tpu_torch.train.callbacks import Callback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, fn, args) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        fn(rank, world, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, join: bool = True):
    """Run ``fn(rank, world, *args)`` in ``world`` processes; any rank's
    failure fails the call. ``join=False`` returns at once: call
    :func:`wait` on the result."""
    return mp.spawn(_entry, args=(world, free_port(), fn, args), nprocs=world, join=join)


@contextlib.contextmanager
def one_thread():
    """torch on one thread while the ranks run beside it: the tiny model's
    steps take no longer, and idle worker threads burn no CPU time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def wait(context) -> None:
    """Join a ``spawn(..., join=False)``; raises if a rank failed."""
    while not context.join():
        pass


def join_cpu() -> None:
    from latte_tpu_torch.dist.mesh import initialize_distributed

    initialize_distributed(device="cpu")


def context(ep: int = 1, sp: int = 1, tp: int = 1):
    from latte_tpu_torch.dist.mesh import DistContext, MeshConfig, make_mesh

    return DistContext(make_mesh(MeshConfig(ep=ep, sp=sp, tp=tp), "cpu"), torch.device("cpu"))


def local_numels(model, optimizer):
    """(parameter elements, first-moment elements) this rank holds."""
    from latte_tpu_torch.dist.sharding import _local

    params = sum(_local(p).numel() for p in model.parameters())
    moments = sum(st["exp_avg"].numel() for st in optimizer.state.values())
    return params, moments


def step_cases(rank: int, world: int, path: str, cases) -> None:
    """Two steps of ``make_train_step`` (AdamW lr 1e-3, weight decay 0.01,
    clip 0.1, EMA 0.9, the Switch loss at 0.01) for each case of ``cases``
    (name, model kwargs, ep, fsdp, zero1) from the one-process weights and
    global batches of ``path``; rank 0 writes the metrics and the full
    parameters and EMA after the steps, every rank its shard sizes."""
    mesh_step_cases(rank, world, path, [dict(name=n, kw=kw, ep=ep, fsdp=fsdp, zero1=zero1)
                                        for n, kw, ep, fsdp, zero1 in cases])


def mesh_step_cases(rank: int, world: int, path: str, cases) -> None:
    """:func:`step_cases` over cases given as dicts: ``name``, ``kw`` (the
    model), and optionally ``ep``, ``sp``, ``tp``, ``fsdp``, ``zero1`` and
    ``mu_dtype`` (AdamW's first-moment type), ``weights`` (the key of the
    one-process weights in ``path``; default the model's ``moe_experts``).
    Writes ``path + ".out"``."""
    from latte_tpu_torch.core.diffusion import create_diffusion
    from latte_tpu_torch.dist.mesh import shard_batch
    from latte_tpu_torch.dist.sharding import ShardedParams, apply_fsdp
    from latte_tpu_torch.models import Latte
    from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
    from latte_tpu_torch.train.step import make_train_step

    data = torch.load(path, weights_only=False)
    out = {}
    for case in cases:
        name, kw = case["name"], case["kw"]
        ctx = context(case.get("ep", 1), case.get("sp", 1), case.get("tp", 1))
        model = Latte(**kw, moe_mesh=ctx, mesh=ctx)
        weights = data["weights"][case.get("weights", kw.get("moe_experts", 0))]
        ShardedParams(model, ctx).load_full_state_dict(model, weights)
        ema = copy.deepcopy(model).requires_grad_(False)
        if case.get("fsdp"):
            apply_fsdp(model, ctx)
            apply_fsdp(ema, ctx)
        shards = ShardedParams(model, ctx, zero1=case.get("zero1", False))
        opt = make_optimizer(model, 0.01, params=shards.leaves, mu_dtype=case.get("mu_dtype"))
        state = create_train_state(model, opt, make_lr_schedule(1e-3), ema)
        step = make_train_step(create_diffusion(""), ema_decay=0.9, clip_max_norm=0.1, start_clip_iter=0,
                               moe_aux_weight=0.01 if kw.get("moe_experts") else 0.0, shards=shards)
        metrics = []
        for batch in data["batches"]:
            m = step(state, shard_batch(batch, ctx), torch.Generator())
            metrics.append({k: float(v) for k, v in m.items() if v.ndim == 0})
        full = shards.full_state_dict(model), shards.full_state_dict(ema)
        numels = [None] * world
        dist.all_gather_object(numels, local_numels(model, opt))
        if rank == 0:
            out[name] = {"metrics": metrics, "model": full[0], "ema": full[1], "numels": numels,
                         "dp": ctx.dp, "ep": ctx.ep, "sp": ctx.sp, "tp": ctx.tp}
    if rank == 0:
        torch.save(out, path + ".out")


class Record(Callback):
    """Keeps each log's metrics and the experts of the first block."""

    def __init__(self):
        self.metrics, self.experts = [], 0

    def on_train_start(self, config, state, experiment_dir):
        block = next(iter(state.model.blocks))  # a pipeline stage's first
        self.experts = block.moe.local_experts if getattr(block, "is_moe", False) else 0

    def on_log(self, step, metrics):
        self.metrics.append(dict(metrics, step=step))


def train_run(rank: int, world: int, config_path: str, overrides, out: str) -> None:
    """``train.main`` on the CPU at this world size; every rank writes its
    result, its logged metrics and the number of experts it holds."""
    from latte_tpu_torch.config import load_config
    from latte_tpu_torch.train import train

    rec = Record()
    result = train.main(load_config(config_path, list(overrides)), callbacks=[rec], device="cpu")
    torch.save({"result": result, "metrics": rec.metrics, "experts": rec.experts}, f"{out}.{rank}")


def resume_run(rank: int, world: int, config_path: str, overrides, results: str, out: str) -> None:
    """:func:`train_run` resumed from the step-2 checkpoint under ``results``."""
    ckpt = sorted(glob.glob(os.path.join(results, "*", "checkpoints", "0000002.pt")))[0]
    train_run(rank, world, config_path, list(overrides) + [f"resume_from_checkpoint={ckpt}"], out)


def sample_run(rank: int, world: int, config_path: str, overrides) -> None:
    """``sample_many.main`` on the CPU at this world size."""
    from latte_tpu_torch.config import load_config
    from latte_tpu_torch.sample import sample_many

    sample_many.main(load_config(config_path, list(overrides)), device="cpu")


def jobs(rank: int, world: int, todo) -> None:
    """Join the gloo group, then run each ``(fn, args)`` of ``todo`` in turn."""
    join_cpu()
    for fn, args in todo:
        fn(rank, world, *args)


def sample_main_run(rank: int, world: int, config_path: str, overrides) -> None:
    """``sample.main`` on the CPU at this world size (tensor-parallel
    serving: rank 0 writes the latents)."""
    from latte_tpu_torch.config import load_config
    from latte_tpu_torch.sample import sample

    sample.main(load_config(config_path, list(overrides)), device="cpu")


def warm_sampler(name, diffusion):
    """The loss-aware timestep sampler with its history already full (past
    its warm-up of ``history_per_term`` losses at every timestep) from a
    numpy seed, so a short run draws t from the loss-weighted distribution
    and moves it with each step's losses."""
    import numpy as np

    from latte_tpu_torch.core.timestep_samplers import LossSecondMomentResampler

    assert name == "loss-second-moment", name
    s = LossSecondMomentResampler(diffusion)
    s._loss_history[:] = np.random.default_rng(3).random(s._loss_history.shape) + 0.05
    s._loss_counts[:] = s.history_per_term
    assert s._warmed_up()
    return s


def warm_train_run(rank: int, world: int, config_path: str, overrides, out: str) -> None:
    """:func:`train_run` with the loss-aware sampler past its warm-up
    (:func:`warm_sampler`)."""
    from latte_tpu_torch.train import train

    plain = train.create_named_schedule_sampler
    train.create_named_schedule_sampler = warm_sampler
    try:
        train_run(rank, world, config_path, overrides, out)
    finally:
        train.create_named_schedule_sampler = plain


# -- pipeline parallelism (tests/test_torch_dist_pp.py) -------------------------

def pp_context(pp: int):
    """The (dp, pp) context of the world at ``pp`` stages."""
    from latte_tpu_torch.dist.mesh import DistContext, MeshConfig, make_mesh

    return DistContext(make_mesh(MeshConfig(pp=pp), "cpu"), torch.device("cpu"))


def _tensor(v):
    """An input array as a tensor; a flag, a seed or None as it is."""
    return v if v is None or isinstance(v, (bool, int, torch.Tensor)) else torch.as_tensor(v)


def _stage_model(case, ctx):
    """A case's model built for this rank's stage, with its pairs of the
    case's JAX parameters (through the converters' stage split)."""
    from latte_tpu_torch.convert import flax_t2v_to_state_dict, load_flax_params
    from latte_tpu_torch.models import Latte
    from latte_tpu_torch.models.dit_img import LatteIMG
    from latte_tpu_torch.models.t2v import LatteT2V

    if case["kind"] == "t2v":
        model = LatteT2V(**case["kw"], pp=ctx.pp, pp_rank=ctx.pp_rank)
        model.load_state_dict(flax_t2v_to_state_dict(case["params"], pp=ctx.pp, pp_rank=ctx.pp_rank), strict=True)
        return model
    cls = LatteIMG if case["kind"] == "img" else Latte
    return load_flax_params(cls(**case["kw"], pp=ctx.pp, pp_rank=ctx.pp_rank), case["params"])


def pp_forward_cases(rank: int, world: int, path: str) -> None:
    """Each case of ``path`` (its kind, model, JAX parameters, inputs and
    microbatches) through the pipelined forward at pp = ``world``: the
    output and, for a ``grad`` case, every parameter's gradient of
    mean(out²) (a non-block one summed over the stages, by
    ``ShardedParams.reduce_grads``); rank 0 writes ``path + ".fwd"``."""
    from latte_tpu_torch.dist.pipeline import (
        pipelined_latte_forward,
        pipelined_latte_img_forward,
        pipelined_t2v_forward,
    )
    from latte_tpu_torch.dist.sharding import ShardedParams

    fns = {"latte": pipelined_latte_forward, "img": pipelined_latte_img_forward, "t2v": pipelined_t2v_forward}
    data = torch.load(path, weights_only=False)
    ctx = pp_context(world)
    out = {}
    for name, case in data.items():
        model = _stage_model(case, ctx)
        kwargs = {k: _tensor(v) for k, v in case.get("kwargs", {}).items()}
        if "generator_seed" in kwargs:
            kwargs["generator"] = torch.Generator().manual_seed(kwargs.pop("generator_seed"))
        args = [None if a is None else torch.as_tensor(a) for a in case["args"]]
        with torch.set_grad_enabled(case.get("grad", False)):
            y = fns[case["kind"]](model, *args, mesh=ctx, microbatches=case["M"], **kwargs)
        grads = None
        if case.get("grad"):
            y.square().mean().backward()
            ShardedParams(model, ctx).reduce_grads()
            mine = {n: p.grad for n, p in model.named_parameters()}
            parts = [None] * world
            dist.all_gather_object(parts, mine)
            grads = {k: v for part in parts for k, v in part.items()}
        out[name] = dict(out=y.detach(), grads=grads)
    if rank == 0:
        torch.save(out, path + ".fwd")


def pp_step_cases(rank: int, world: int, path: str) -> None:
    """Two steps of ``make_train_step`` (AdamW lr 1e-3, weight decay 0.01,
    clip 0.1, EMA 0.9) through the pipelined apply for each case of
    ``path`` (name, pp, zero1, microbatches) from the JAX parameters and
    global batches there; rank 0 writes the metrics, the full parameters,
    EMA and optimizer state after the steps and every rank's block
    parameter count to ``path + ".step"``."""
    from latte_tpu_torch.core.diffusion import create_diffusion
    from latte_tpu_torch.dist.mesh import shard_batch
    from latte_tpu_torch.dist.pipeline import make_pipelined_apply
    from latte_tpu_torch.dist.sharding import ShardedParams, stage_block
    from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
    from latte_tpu_torch.train.step import make_train_step

    data = torch.load(path, weights_only=False)
    out = {}
    for name, pp, zero1, M in data["cases"]:
        ctx = pp_context(pp)
        model = _stage_model(dict(kind="latte", kw=data["kw"], params=data["params"]), ctx)
        ema = copy.deepcopy(model).requires_grad_(False)
        shards = ShardedParams(model, ctx, zero1=zero1)
        opt = make_optimizer(model, 0.01, params=shards.leaves)
        state = create_train_state(model, opt, make_lr_schedule(1e-3), ema)
        step = make_train_step(create_diffusion(""), ema_decay=0.9, clip_max_norm=0.1, start_clip_iter=0,
                               shards=shards, apply_fn=make_pipelined_apply(model, ctx, M))
        metrics = []
        for batch in data["batches"]:
            m = step(state, shard_batch(batch, ctx), torch.Generator())
            metrics.append({k: float(v) for k, v in m.items() if v.ndim == 0})
        full = shards.full_state_dict(model), shards.full_state_dict(ema), shards.full_optimizer_state(opt)
        blocks = [None] * world
        dist.all_gather_object(blocks, sum(p.numel() for n, p in model.named_parameters() if stage_block(n)))
        if rank == 0:
            out[name] = dict(metrics=metrics, model=full[0], ema=full[1], opt=full[2], blocks=blocks,
                             dp=ctx.dp, pp=ctx.pp)
    if rank == 0:
        torch.save(out, path + ".step")


def sample_t2x_run(rank: int, world: int, config_path: str, overrides, out: str) -> None:
    """``sample_t2x.main`` on the CPU at this world size; rank 0 writes the
    records' latents and paths, the others their paths."""
    from latte_tpu_torch.config import load_config
    from latte_tpu_torch.sample import sample_t2x

    records = sample_t2x.main(load_config(config_path, list(overrides)), device="cpu")
    torch.save([dict(latents=r["latents"], path=r["path"]) for r in records], f"{out}.{rank}")


# -- evaluation (tests/test_torch_eval_metrics.py) ------------------------------

def eval_stats_run(rank: int, world: int, config_path: str, overrides, real: str, fake: str, kw: dict,
                   out: str) -> None:
    """The metric stats at this world size with the stand-in detector: from
    a tiny ``sample_many.BatchGenerator`` (its clips of each call recorded)
    and from the files (``_video_stats`` on ``real``, ``_frame_stats`` on
    ``fake``, batch sizes ``kw`` that the world does not divide); every
    rank writes its clips and stats to ``out.<rank>``."""
    from latte_tpu_torch.config import load_config
    from latte_tpu_torch.eval import detectors, metrics
    from latte_tpu_torch.sample import sample_many

    det = detectors.standin_detector()
    gen = sample_many.BatchGenerator(load_config(config_path, list(overrides)), device="cpu")
    clips = []

    def gen_fn(n):
        clips.append(gen(n))
        return clips[-1]

    stats = dict(
        generator=metrics.generator_stats(gen_fn, det, detectors.i3d_features, max_items=kw["gen_items"],
                                          num_frames=16),
        video=metrics._video_stats(real, det, detectors.i3d_features, 16, kw["clips"], subsample_factor=3,
                                   batch_size=kw["video_batch"], capture_all=True),
        frames=metrics._frame_stats(fake, det, kw["frames"], batch_size=kw["frame_batch"], capture_all=True),
    )
    torch.save({"clips": clips, "stats": {k: v.__dict__ for k, v in stats.items()}}, f"{out}.{rank}")


def support_run(rank: int, world: int, out: str) -> None:
    """``stats.Collector`` over gloo (each rank its own reports) and
    ``diagnostics.check_params_consistency`` on a replicated module, then
    with rank 1's tensor nudged; each rank writes what it saw."""
    import json

    from latte_tpu_torch import diagnostics, stats

    join_cpu()
    rng = torch.Generator().manual_seed(rank)
    stats.reset()
    stats.report("loss", torch.randn(5 + rank, generator=rng, dtype=torch.float64))
    stats.report0("only0", [1.0, 2.0, 4.0])
    stats.report("x", 3.0 + rank)
    col = stats.Collector(regex="loss|only0|x")
    col.update()
    torch.manual_seed(0)
    layer = torch.nn.Linear(4, 3)
    seen = {"stats": col.as_dict(), "consistent": diagnostics.check_params_consistency(layer)}
    with torch.no_grad():
        if rank == 1:
            layer.bias[1] += 1e-6
    try:
        diagnostics.check_params_consistency(layer)
        seen["nudged"] = None
    except AssertionError as e:
        seen["nudged"] = str(e)
    with open(os.path.join(out, f"support{rank}.json"), "w") as f:
        json.dump(seen, f)


def aot_tp_run(rank: int, world: int, paths, state_path: str, z_path: str, out: str) -> None:
    """Each tensor-parallel artifact of ``paths`` loaded and called with the
    whole state dict on this rank (the loader keeps the rank's part); the
    latents to ``out/aot<i>.<rank>.pt``."""
    from latte_tpu_torch.serve import aot

    join_cpu()
    state, z = torch.load(state_path), torch.load(z_path)
    for i, path in enumerate(paths):
        call = aot.load_sampler(path)
        torch.save(call(state, z), os.path.join(out, f"aot{i}.{rank}.pt"))
