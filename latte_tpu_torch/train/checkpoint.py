"""Checkpoints in the reference ``.pt`` layout (port of
``latte_tpu/train/checkpoint.py``; orbax is not reproduced).

One file per step, ``<ckpt_dir>/<step:07d>.pt``, holding
``{"model", "ema", "opt", "step", "args"}``: the model's and the EMA's state
dicts, the optimizer's state dict, the step and the run's config. The
port's sampler reads it through
:func:`latte_tpu_torch.convert.load_reference_checkpoint`, preferring EMA,
and the trainer's ``pretrained`` option through :func:`load_pretrained`.

Over several GPUs (``shards``, a ``dist.sharding.ShardedParams``) every
rank takes part in gathering the full state from its FSDP, ZeRO-1, expert
and tensor-parallel shards and its pipeline stage's blocks, rank 0 writes
it in the same format (the names carry no wrapper prefix; the optimizer's
entries indexed as one process indexes them), and the others wait at a
barrier; on load each rank takes its parts, a stage its blocks, whatever
world size wrote the file.

``save_checkpoint(..., block=False)`` is the trainer's ``async_checkpoint``
(on by default, as in the JAX trainer): the state is copied to the host
before the call returns and the file is written in a background thread;
:func:`wait_for_saves` waits for it.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

import torch
import yaml

from latte_tpu_torch.convert import load_reference_checkpoint
from latte_tpu_torch.dist.mesh import barrier, is_main_process
from latte_tpu_torch.dist.sharding import _local, is_expert
from latte_tpu_torch.train.state import TrainState

__all__ = [
    "save_checkpoint",
    "wait_for_saves",
    "load_checkpoint",
    "restore_train_state",
    "latest_checkpoint",
    "latest_checkpoint_under",
    "find_model",
    "load_pretrained",
]


def save_checkpoint(
    path: str, state: TrainState, args: Optional[Dict[str, Any]] = None, shards=None, *, block: bool = True
) -> str:
    """Write the whole train state to ``path``; atomic (a reader never sees
    a partial file). With ``shards`` every rank must call it.

    ``block=False`` (the trainer's ``async_checkpoint``, as in JAX): the
    state is copied to the host before the call returns, so the next
    optimizer step may change it at once, and rank 0's ``torch.save`` runs
    in a background thread. At most one write is in flight: a call first
    waits for the last one. Call :func:`wait_for_saves` before reading the
    file or exiting; an error of the background write is raised there or by
    the next call. Under ``shards`` the gathers stay collective and
    synchronous; only rank 0's write leaves the step loop."""
    wait_for_saves()
    if shards is None:
        model, ema, opt = state.model.state_dict(), state.ema.state_dict(), state.optimizer.state_dict()
    else:
        model, ema = shards.full_state_dict(state.model), shards.full_state_dict(state.ema)
        opt = shards.full_optimizer_state(state.optimizer)
    if is_main_process():
        payload = {"model": model, "ema": ema, "opt": opt, "step": int(state.step), "args": dict(args or {})}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if block:
            _write(path, payload)
        else:
            payload = _snapshot(payload, _live_storages(state))
            _WRITER["thread"] = threading.Thread(target=_write_in_background, args=(path, payload),
                                                 name="latte-checkpoint-writer", daemon=True)
            _WRITER["thread"].start()
        del payload
    del model, ema, opt
    barrier()
    return path


# the background write in flight, and the error of the last one
_WRITER: Dict[str, Any] = {"thread": None, "error": None}


def _write(path: str, payload: dict) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _write_in_background(path: str, payload: dict) -> None:
    try:
        _write(path, payload)
    except Exception as e:  # raised by the caller's next wait
        _WRITER["error"] = (path, e)


def _live_storages(state: TrainState) -> set:
    """The addresses of the train state's host storages: the model's, the
    EMA's and the optimizer's CPU tensors (its ``step`` counters among them,
    even in a CUDA run), which the next step changes in place."""
    tensors = [*state.model.state_dict().values(), *state.ema.state_dict().values(),
               *(v for st in state.optimizer.state.values() for v in st.values() if isinstance(v, torch.Tensor))]
    return {_local(t).untyped_storage().data_ptr() for t in tensors if t.device.type == "cpu"}


def _snapshot(obj, live: set):
    """A copy of the payload on the host that shares no storage with the
    live state: CUDA tensors copied to the host, CPU tensors whose storage
    is in ``live`` cloned (a gather's own host copies are kept as they are)."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu":
            return obj.detach().to("cpu")
        return obj.detach().clone() if _local(obj).untyped_storage().data_ptr() in live else obj.detach()
    if isinstance(obj, dict):
        return type(obj)((k, _snapshot(v, live)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v, live) for v in obj)
    return obj


def wait_for_saves() -> None:
    """Block until the background checkpoint write (if any) is on disk;
    raise its error, if it had one."""
    thread = _WRITER["thread"]
    if thread is not None:
        thread.join()
        _WRITER["thread"] = None
    if _WRITER["error"] is not None:
        path, err = _WRITER["error"]
        _WRITER["error"] = None
        raise RuntimeError(f"the background write of checkpoint {path} failed: {err!r}") from err


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def restore_train_state(state: TrainState, payload: Dict[str, Any], shards=None) -> TrainState:
    """Load step, model, EMA and optimizer state into ``state`` in place;
    with ``shards``, each rank its parts."""
    if shards is None:
        state.model.load_state_dict(payload["model"], strict=True)
        state.ema.load_state_dict(payload["ema"], strict=True)
        state.optimizer.load_state_dict(payload["opt"])
    else:
        shards.load_full_state_dict(state.model, payload["model"])
        shards.load_full_state_dict(state.ema, payload["ema"])
        shards.load_full_optimizer_state(state.optimizer, payload["opt"])
    state.step = int(payload["step"])
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest step-numbered checkpoint (e.g. ``0050000.pt``) in a dir."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [f[:-3] for f in os.listdir(ckpt_dir) if f.endswith(".pt") and f[:-3].isdigit()]
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps, key=int) + ".pt")


def latest_checkpoint_under(results_dir: str, model: Optional[str] = None) -> Optional[str]:
    """The highest-step checkpoint over every ``<results_dir>/*/checkpoints``;
    with ``model``, experiments whose saved config names another model are
    skipped."""
    if not os.path.isdir(results_dir):
        return None

    def exp_model(exp: str) -> Optional[str]:
        try:
            with open(os.path.join(results_dir, exp, "config.yaml")) as f:
                m = (yaml.safe_load(f) or {}).get("model")
        except (OSError, yaml.YAMLError):
            return None  # unreadable config: don't exclude
        return None if m is None else str(m)

    best, best_step = None, -1
    for exp in sorted(os.listdir(results_dir)):
        if model is not None and exp_model(exp) not in (None, str(model)):
            continue
        cand = latest_checkpoint(os.path.join(results_dir, exp, "checkpoints"))
        if cand is not None:
            step = int(os.path.basename(cand)[:-3])
            if step > best_step:
                best, best_step = cand, step
    return best


def find_model(path: str, prefer_ema: bool = True) -> Dict[str, torch.Tensor]:
    """Inference weights (a state dict) from a checkpoint; EMA preferred."""
    return load_reference_checkpoint(path, prefer_ema=prefer_ema)


def load_pretrained(model: torch.nn.Module, path: str, ctx=None) -> int:
    """The partial load of ``pretrained`` (the JAX trainer's, after the
    reference ``train.py``): from a reference ``.pt`` or a port checkpoint
    (EMA preferred, :func:`find_model`), every parameter whose name and shape
    match overwrites the model's; every other keeps its value. Returns the
    number kept. Under expert parallelism (``ctx``) an expert weight is
    cut to this rank's experts first; a pipeline stage's model takes its
    own blocks (it holds no other names). A path that does not exist raises ``FileNotFoundError``
    (the JAX trainer ignores it), a directory (an orbax checkpoint)
    ``NotImplementedError``."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"pretrained {path!r} does not exist")
    if os.path.isdir(path):
        raise NotImplementedError(
            f"pretrained {path!r} is a directory, as the JAX trainer's orbax checkpoints are; "
            "the port reads a reference-format .pt (see latte_tpu_torch.convert.flax_to_state_dict)"
        )
    loaded = find_model(path)
    kept = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            cand = loaded.get(name)
            if cand is not None and ctx is not None and ctx.ep > 1 and is_expert(name):
                cand = cand.chunk(ctx.ep)[ctx.ep_rank] if cand.shape[0] % ctx.ep == 0 else cand
            if cand is not None and tuple(cand.shape) == tuple(p.shape):
                p.copy_(cand)
            else:
                kept += 1
    return kept
