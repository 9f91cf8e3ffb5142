"""The port's support code against the JAX package's
(``latte_tpu_torch/{stats,diagnostics,profiling,persistence,utils}.py``)
and the asynchronous checkpoint (``train/checkpoint.py``,
``async_checkpoint`` in ``train.main``).

Tolerances: the statistics and the sampler orders are equal (both sides
compute in fp64 numpy); ``cost_analysis``'s bytes within 1% of XLA's
``bytes accessed`` and its flops exact; checkpoints equal to the bit. World
2 runs in one ``torch.multiprocessing`` spawn over gloo
(``tests/torch_dist_util.py``).
"""

import json
import os
import pickle
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import one_cpu_thread

from latte_tpu import diagnostics as jax_diagnostics
from latte_tpu import profiling as jax_profiling
from latte_tpu import stats as jax_stats
from latte_tpu.models import get_model as jax_get_model
from latte_tpu_torch import diagnostics, persistence, profiling, stats, utils
from latte_tpu_torch.config import load_config
from latte_tpu_torch.models import Latte, get_model
from latte_tpu_torch.train import train
from latte_tpu_torch.train.callbacks import Callback
from latte_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint, wait_for_saves
from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFS_TRAIN = os.path.join(REPO, "configs", "ffs", "ffs_train.yaml")
TINY_TRAIN = ["image_size=32", "num_frames=2", "model_overrides={depth: 2, hidden_size: 32, num_heads: 2}",
              "local_batch_size=2", "log_every=1", "learning_rate=1e-3", "max_train_steps=3", "ckpt_every=1"]
TINY_ARCH = dict(input_size=2, num_frames=2, hidden_size=32, depth=4, num_heads=2, patch_size=1)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_cpu_thread():
        yield


def test_collector_equals_jax():
    rng = np.random.default_rng(0)
    reports = [("loss", rng.standard_normal(7)), ("loss", rng.standard_normal(3)), ("lr", 1e-4),
               ("grad", rng.standard_normal((2, 3))), ("empty", np.zeros(0))]
    results = []
    for mod in (stats, jax_stats):
        mod.reset()
        for name, value in reports:
            mod.report(name, value)
        mod.report0("zero", [1.0, 3.0])
        col = mod.Collector(regex="loss|lr|grad|zero|empty")
        col.update()
        first = col.as_dict()
        mod.report("loss", 5.0)
        col.update()  # lr, grad, zero: no new reports, the previous moments kept
        results.append((first, col.as_dict()))
        mod.reset()
    assert json.dumps(results[0], sort_keys=True) == json.dumps(results[1], sort_keys=True)  # NaN == NaN
    assert results[0][0]["loss"]["num"] == 10 and results[0][1]["loss"]["num"] == 1


def test_torch_tensors_report_as_arrays():
    stats.reset()
    stats.report("x", torch.tensor([1.0, 2.0, 3.0], dtype=torch.bfloat16))
    col = stats.Collector()
    col.update()
    assert (col.num("x"), col.mean("x")) == (3, 2.0)
    stats.reset()


def test_world_two_stats_and_consistency(tmp_path):
    """At world 2 over gloo the collector's moments are those of one process
    holding both ranks' reports; the consistency check passes on a
    replicated layer and names the tensor one rank nudged."""
    from torch_dist_util import spawn, support_run

    spawn(support_run, 2, str(tmp_path))
    seen = [json.load(open(tmp_path / f"support{r}.json")) for r in range(2)]
    stats.reset()
    for rank in range(2):
        rng = torch.Generator().manual_seed(rank)
        stats.report("loss", torch.randn(5 + rank, generator=rng, dtype=torch.float64))
        stats.report("x", 3.0 + rank)
    stats.report("only0", [1.0, 2.0, 4.0])
    col = stats.Collector()
    col.update()
    want = col.as_dict()
    stats.reset()
    for s in seen:
        for name in want:
            for key in ("num", "mean", "std"):
                assert s["stats"][name][key] == pytest.approx(want[name][key], rel=1e-15, abs=1e-15), (name, key)
        assert s["consistent"] is True
        assert s["nudged"] is not None and "bias" in s["nudged"]


def test_infinite_sampler_equals_jax():
    for kw in (dict(dataset_size=11, rank=1, num_replicas=3, seed=5), dict(dataset_size=7, shuffle=False)):
        mine, theirs = iter(diagnostics.InfiniteSampler(**kw)), iter(jax_diagnostics.InfiniteSampler(**kw))
        assert [next(mine) for _ in range(40)] == [next(theirs) for _ in range(40)]
        assert np.array_equal(diagnostics.InfiniteSampler(**kw).epoch_order(3),
                              jax_diagnostics.InfiniteSampler(**kw).epoch_order(3))


def test_count_params_equals_jax():
    jm = jax_get_model("Latte-S/2", attention_mode="xla", **TINY_ARCH)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 4, 2, 2)),
                                            jnp.zeros((1,), jnp.int32)))
    model = get_model("Latte-S/2", **TINY_ARCH)
    assert diagnostics.count_params(model) == jax_diagnostics.count_params(params) > 0
    assert diagnostics.count_params(dict(model.named_parameters())) == diagnostics.count_params(model)


def test_shapes_nonfinite_and_summary(capsys):
    x = torch.zeros(2, 3, 4)
    diagnostics.assert_shape(x, [2, None, 4])
    with pytest.raises(AssertionError, match="dim 1"):
        diagnostics.assert_shape(x, [2, 5, 4])
    with pytest.raises(AssertionError, match="rank"):
        diagnostics.assert_shape(x, [2, 3])
    model = get_model("Latte-S/2", **TINY_ARCH).eval()
    assert diagnostics.find_nonfinite(model) == []
    with torch.no_grad():
        model.blocks[1].attn.qkv.weight[0, 0] = float("nan")
    assert diagnostics.find_nonfinite(model) == ["blocks.1.attn.qkv.weight"]
    assert diagnostics.find_nonfinite({"a": torch.ones(2), "b": torch.tensor([1.0, float("inf")]),
                                       "i": torch.ones(2, dtype=torch.int64)}) == ["b"]
    assert diagnostics.check_params_consistency(model)  # one process: nothing to compare
    model = get_model("Latte-S/2", **TINY_ARCH).eval()
    table = diagnostics.print_module_summary(model, torch.zeros(1, 2, 4, 2, 2), torch.zeros(1, dtype=torch.int64))
    assert table in capsys.readouterr().out
    for name in ("(model)", "blocks.0", "blocks.3", "final_layer", "x_embedder"):
        assert name in table, name
    assert "(1, 2, 8, 2, 2)" in table and f"{diagnostics.count_params(model):,}" in table


def test_cost_analysis_matmul_equals_jax():
    a, b = torch.ones(64, 64), torch.ones(64, 64)
    mine = profiling.cost_analysis(torch.matmul, a, b)
    theirs = jax_profiling.cost_analysis(jnp.dot, jnp.ones((64, 64)), jnp.ones((64, 64)))
    assert mine["flops"] == 2 * 64**3 == theirs["flops"]
    assert abs(mine["bytes_accessed"] - theirs["bytes_accessed"]) <= 0.01 * theirs["bytes_accessed"]


def test_trace_timer_benchmark(tmp_path):
    f = profiling.profiled_function(lambda x: x @ x)
    with profiling.trace(str(tmp_path)) as prof:
        f(torch.ones(8, 8))
    assert any(e.key == "<lambda>" for e in prof.key_averages())
    assert os.path.getsize(tmp_path / profiling.TRACE_FILE) > 0
    timer = profiling.Timer()
    assert timer.elapsed(torch.ones(2)) >= 0
    assert profiling.benchmark(torch.matmul, torch.ones(4, 4), torch.ones(4, 4), iters=3) > 0


def test_persistent_class_loads_without_its_module(tmp_path, monkeypatch):
    (tmp_path / "archived_thing.py").write_text(
        "from latte_tpu_torch.persistence import persistent_class\n\n\n"
        "@persistent_class\nclass Thing:\n    def __init__(self, a):\n        self.a = a\n\n"
        "    def double(self):\n        return self.a * 2\n"
    )
    monkeypatch.syspath_prepend(str(tmp_path))
    import archived_thing

    thing = archived_thing.Thing(21)
    assert persistence.is_persistent(thing)
    data = pickle.dumps(thing)
    assert b"class Thing" in data and b"latte_tpu_torch.persistence" in data
    del sys.modules["archived_thing"]
    (tmp_path / "archived_thing.py").unlink()
    back = pickle.loads(data)
    assert back.double() == 42 and "archived_thing" not in sys.modules


def test_construction_by_name(tmp_path):
    model = utils.construct_class_by_name("latte_tpu_torch.models.Latte", **TINY_ARCH)
    assert isinstance(model, Latte) and model.depth == 4
    assert utils.get_obj_by_name("latte_tpu_torch.models.registry.get_model") is get_model
    with pytest.raises(ImportError):
        utils.get_obj_by_name("latte_tpu_torch.models.NoSuchThing")
    videos = np.random.default_rng(0).integers(0, 255, (3, 2, 8, 8, 3), dtype=np.uint8)
    utils.save_video_grid(str(tmp_path / "g.mp4"), videos)
    assert utils.read_video(str(tmp_path / "g.mp4")).shape == (2, 16, 16, 3)


def _state(seed=0):
    torch.manual_seed(seed)
    model = get_model("Latte-S/2", **TINY_ARCH)
    opt = make_optimizer(model, 0.0)
    state = create_train_state(model, opt, make_lr_schedule(1e-3, 0))
    model(torch.randn(2, 2, 4, 2, 2), torch.tensor([1, 2])).square().mean().backward()
    opt.step()
    state.step = 1
    return state


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_async_checkpoint_equals_blocking_and_snapshots_at_the_call(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path / "sync.pt"), state, {"k": 1})
    save_checkpoint(str(tmp_path / "async.pt"), state, {"k": 1}, block=False)
    with torch.no_grad():  # changed after the call returned: not in the file
        state.model.blocks[0].attn.qkv.weight.add_(1.0)
        state.ema.final_layer.linear.bias.add_(1.0)
    next(iter(state.optimizer.state.values()))["exp_avg"].add_(1.0)
    for st in state.optimizer.state.values():  # as the next optimizer step counts
        st["step"].add_(1)
    wait_for_saves()
    sync, asy = load_checkpoint(str(tmp_path / "sync.pt")), load_checkpoint(str(tmp_path / "async.pt"))
    assert _equal(sync, asy)
    assert not torch.equal(asy["model"]["blocks.0.attn.qkv.weight"], state.model.blocks[0].attn.qkv.weight)
    assert {float(st["step"]) for st in asy["opt"]["state"].values()} == {1.0}
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_async_snapshot_clones_the_live_host_state_and_keeps_gathered_copies():
    """What a multi-GPU save hands the writer: its gathers' host copies (kept
    as they are) beside the optimizer's ``step`` counters, which live on the
    CPU and which the next step advances in place (cloned)."""
    from latte_tpu_torch.train import checkpoint

    state = _state()
    live = next(iter(state.optimizer.state.values()))
    gathered = {k: live[k].clone() for k in ("exp_avg", "exp_avg_sq")}
    payload = {"opt": {"state": {0: dict(gathered, step=live["step"])}}, "model": state.model.state_dict()}
    snap = checkpoint._snapshot(payload, checkpoint._live_storages(state))
    got = snap["opt"]["state"][0]
    for k in gathered:
        assert got[k].data_ptr() == gathered[k].data_ptr()
    live["step"].add_(1)
    state.model.blocks[0].attn.qkv.weight.data.add_(1.0)
    assert float(got["step"]) == 1.0
    assert torch.equal(snap["model"]["blocks.0.attn.qkv.weight"] + 1.0, state.model.blocks[0].attn.qkv.weight)


def test_async_write_error_is_raised_by_the_next_wait(tmp_path):
    state = _state()
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    save_checkpoint(str(tmp_path / "ok.pt"), state, block=False)
    with pytest.raises(Exception):
        save_checkpoint(str(blocker / "x.pt"), state, block=False)  # the directory cannot be made
    wait_for_saves()
    # a write that fails in the background is raised by the next wait, once
    from latte_tpu_torch.train import checkpoint

    def fail(path, payload):
        raise OSError("disk full")

    orig = checkpoint._write
    checkpoint._write = fail
    try:
        save_checkpoint(str(tmp_path / "bad.pt"), state, block=False)
    finally:
        checkpoint._write = orig
    with pytest.raises(RuntimeError, match="bad.pt"):
        wait_for_saves()
    wait_for_saves()


def _final(result):
    ckpts = os.path.join(result["experiment_dir"], "checkpoints")
    return {f: load_checkpoint(os.path.join(ckpts, f)) for f in sorted(os.listdir(ckpts))}


def test_train_main_async_and_sync_checkpoints_equal(tmp_path):
    runs = {}
    for flag in ("true", "false"):
        cfg = load_config(FFS_TRAIN, TINY_TRAIN + [f"results_dir={tmp_path}/{flag}", f"async_checkpoint={flag}"])
        runs[flag] = _final(train.main(cfg, device="cpu"))
    assert list(runs["true"]) == ["0000001.pt", "0000002.pt", "0000003.pt"] == list(runs["false"])
    for name in runs["true"]:
        a, b = runs["true"][name], runs["false"][name]
        assert _equal({k: a[k] for k in ("model", "ema", "opt", "step")},
                      {k: b[k] for k in ("model", "ema", "opt", "step")}), name
    assert not any(t.name == "latte-checkpoint-writer" for t in threading.enumerate())


class _RaiseAfterCheckpoint(Callback):
    def on_checkpoint(self, step, path):
        self.path = path
        raise RuntimeError("callback failed")


def test_an_exception_after_an_async_save_keeps_the_file(tmp_path):
    cfg = load_config(FFS_TRAIN, TINY_TRAIN + [f"results_dir={tmp_path}"])
    cb = _RaiseAfterCheckpoint()
    with pytest.raises(RuntimeError, match="callback failed"):
        train.main(cfg, callbacks=[cb], device="cpu")
    assert not any(t.name == "latte-checkpoint-writer" for t in threading.enumerate())
    payload = load_checkpoint(cb.path)
    assert payload["step"] == 1 and set(payload) == {"model", "ema", "opt", "step", "args"}
