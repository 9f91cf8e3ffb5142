"""The sampler's step as one CUDA graph: the port's ``loop_mode: scan``; and
the program-holding class the trainer's graphed step reuses
(``train.step.GraphedTrainStep``).

JAX compiles the whole denoising trajectory into one XLA program, a
``lax.scan`` over the steps (``latte_tpu/core/samplers.py``), and the block
cache into one scan with a ``lax.cond`` in its body. The counterpart here
is a CUDA graph of one step, captured once on static buffers and replayed
once a timestep: the host issues one graph launch a step instead of the
forward's few hundred kernel launches.

:class:`GraphedStep` takes the place of a sampler step
(``sample.sampler_step``'s ``step(x, t, noise, y)``, or with the block cache
``step(x, t, noise, y, front)`` -> ``(x, front)``) in the loops
(``core.samplers.run_steps``, ``core.block_cache.run_cached_steps``). Each
call writes its x, t, noise and y into the static buffers (outside the
graph; the loops draw each step's noise by their own rule, so a graphed
trajectory draws the numbers an eager one draws), replays, and returns the
static x, which the loop passes back in. The block cache holds two graphs,
the full forward, which copies its front into a static buffer of its own,
and the partial forward, which reads it there; the schedule ``i % interval``
stays on the host, as static as JAX's ``lax.cond`` over it.

:class:`StepGraph` holds one program. Its first call runs the step eagerly
on a side stream, on the static buffers: that is the trajectory's own step,
and the warm-up that puts every first use behind it (the diffusion's device
tables, the kernel library's build and load, each kernel's
``cudaFuncSetAttribute``). Then it captures the step with
``torch.cuda.CUDAGraph``; every later call replays it. One replay launches
the kernels the capture recorded: the capture reads how many of each
hand-written kernel that is from the kernels' launch counters (and puts
them back, since a capture launches nothing), and each replay adds it to
them, so the counters count the launches the card runs.

There is no fallback on the card: an op that cannot be captured (a host
sync, a copy from pageable memory) raises :class:`CaptureError` naming it.
On the CPU, which only a caller asks for, the same static-buffer runner
"replays" by calling the recorded step: it gives the eager loop's numbers
to the bit, and the tests hold it as the graph's plain version.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CaptureError", "GraphedStep", "StepGraph", "launch_counters"]


class CaptureError(RuntimeError):
    """An op of the step could not be captured in a CUDA graph."""


def launch_counters() -> tuple:
    """``(wrapper, attribute)`` of every launch counter of the hand-written
    kernels a sampler or train step runs: B1's forward, B2, B3, B6 and the
    attention backward's B4 (dQ) and B5 (dK/dV)."""
    from latte_tpu_torch.kernels import adaln, attention, attention_int8

    fa, i8 = attention.flash_attention, attention_int8.flash_attention_int8
    bwd = (attention.flash_attention_bwd_dq, attention.flash_attention_bwd_dkv)
    return (
        (fa, "launches"), (fa, "tc_launches"), (fa, "f32_launches"),
        (adaln.ln_modulate, "launches"), (adaln.ln_modulate, "vec_launches"),
        (adaln.residual_ln_modulate, "launches"), (adaln.residual_ln_modulate, "vec_launches"),
        (i8, "launches"), (i8, "tc_launches"),
        *((k, a) for k in bwd for a in ("launches", "tc_launches", "f32_launches")),
    )


class _NameTheOp(TorchDispatchMode):
    """Re-raise an op's failure during a capture of ``program`` as
    :class:`CaptureError` naming the op (running out of memory stays
    ``torch.OutOfMemoryError``)."""

    def __init__(self, program: str = "the sampler's step"):
        super().__init__()
        self.program = program

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        try:
            return func(*args, **(kwargs or {}))
        except (CaptureError, torch.OutOfMemoryError):
            raise
        except Exception as err:
            raise CaptureError(f"{func} cannot be captured in a CUDA graph of {self.program}: {err}") from err


def _memory(device: torch.device) -> str:
    free, total = torch.cuda.mem_get_info(device)
    return (f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved(device) / 2**30:.2f} GiB reserved, {free / 2**30:.2f} GiB free "
            f"of {total / 2**30:.2f} GiB")


class StepGraph:
    """``fn()``, which reads and writes static buffers only, as one CUDA graph
    on ``device``: the first call runs it eagerly on a side stream (the
    warm-up) and captures it, every later call replays it. On another
    device every call runs ``fn`` (and is counted as on the card: the first
    as the capture, the others as replays). ``launches`` is one replay's launches of
    each hand-written kernel (``"flash_attention.tc_launches"``: n);
    ``captures`` and ``replays`` count. ``program`` names the step in a
    :class:`CaptureError`. The warm-up's freed blocks go back to the card
    before the capture, whose private pool holds a second set of the step's
    temporaries; a capture that does not fit raises :class:`CaptureError`
    with the memory's sizes."""

    def __init__(self, fn: Callable[[], None], device: torch.device, program: str = "the sampler's step"):
        self.fn, self.device, self.program = fn, torch.device(device), program
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self._deltas: tuple = ()
        self.captures = self.replays = 0

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
            if self.captures:
                self.replays += 1
            else:  # the first call stands for the capture, as on the card
                self.captures = 1
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            self.graph.replay()
            self.replays += 1
            for (wrapper, attr), n in self._deltas:
                setattr(wrapper, attr, getattr(wrapper, attr) + n)

    def _warm_up_and_capture(self) -> None:
        caller = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            self.fn()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        counters = launch_counters()
        before = [getattr(w, a) for w, a in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side), _NameTheOp(self.program):
                graph.capture_begin()
                try:
                    self.fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:  # the capture is invalid: the op's error is the one to see
                        pass
                    raise
                graph.capture_end()
            deltas = [getattr(w, a) - b for (w, a), b in zip(counters, before)]
        except torch.OutOfMemoryError as err:
            del graph  # its pool goes back with it
            torch.cuda.empty_cache()
            raise CaptureError(f"the CUDA graph of {self.program} does not fit on {self.device}: "
                               f"{_memory(self.device)} after the capture failed: {err}") from err
        finally:  # a capture records launches and runs none
            for (w, a), b in zip(counters, before):
                setattr(w, a, b)
        caller.wait_stream(side)
        self.graph, self.captures = graph, self.captures + 1
        self._deltas = tuple((c, n) for c, n in zip(counters, deltas) if n)
        self.launches = {f"{w.__name__}.{a}": n for (w, a), n in self._deltas}

    def release(self) -> None:
        """Drop the graph and its memory pool; the next call captures anew."""
        if self.graph is not None:
            self.graph.reset()
        self.graph, self._deltas, self.launches = None, (), {}


def _put(buf: torch.Tensor, value: torch.Tensor) -> None:
    if value is not buf:
        buf.copy_(value)


class GraphedStep:
    """A sampler step on static buffers, replayed as a CUDA graph on the
    card (see the module docstring): call it as the step it wraps,
    ``(x, t, noise, y=None)`` -> the static x, or with ``cached``
    ``(x, t, noise, y, front)`` -> ``(static x, static front)``, ``front``
    None for the full forward. The buffers and graphs are made for the
    first call's x and y and made again (a new capture) when their shape,
    dtype or device changes, or when an address in ``weights()`` (the
    tensors the step reads besides its inputs: the model's parameters and
    buffers) does; that is checked when a call's x is not the static x,
    i.e. at a trajectory's first step. A trajectory's calls must not
    interleave with another's: the buffers are shared."""

    def __init__(self, step, cached: bool = False, weights: Callable[[], Iterable[torch.Tensor]] = tuple):
        self.step, self.cached, self.weights = step, bool(cached), weights
        self.key = None
        self.graphs: Dict[str, StepGraph] = {}
        self.captures = 0
        self.x = self.t = self.noise = self.y = self.front = None

    @property
    def launches(self) -> Dict[str, Dict[str, int]]:
        """One replay's kernel launches, by program ("step"; "full" and
        "partial" with the block cache)."""
        return {name: dict(g.launches) for name, g in self.graphs.items()}

    def _bind(self, x: torch.Tensor, y: Optional[torch.Tensor]) -> None:
        key = (tuple(x.shape), x.dtype, x.device, None if y is None else (tuple(y.shape), y.dtype),
               tuple(w.data_ptr() for w in self.weights()))
        if key == self.key:
            return
        self.release()
        self.key = key
        self.x, self.noise = torch.empty_like(x), torch.empty_like(x)
        self.t = torch.empty(x.shape[:1], dtype=torch.int64, device=x.device)
        self.y = None if y is None else torch.empty_like(y)

    def _program(self, name: str) -> StepGraph:
        graph = self.graphs.get(name)
        if graph is None:
            graph = self.graphs[name] = StepGraph(getattr(self, f"_{name}"), self.x.device)
        return graph

    def _step(self) -> None:
        self.x.copy_(self.step(self.x, self.t, self.noise, self.y))

    def _full(self) -> None:
        out, front = self.step(self.x, self.t, self.noise, self.y, None)
        if self.front is None:  # made by the eager first call, before the capture
            self.front = torch.empty_like(front)
        self.x.copy_(out)
        self.front.copy_(front)

    def _partial(self) -> None:
        out, _ = self.step(self.x, self.t, self.noise, self.y, self.front)
        self.x.copy_(out)

    def __call__(self, x, t, noise, y=None, front=None):
        if x is not self.x:  # a trajectory's first step: the loop passes the static x back after it
            self._bind(x, y)
            self.x.copy_(x)
        _put(self.t, t)
        _put(self.noise, noise)
        if y is not None:
            _put(self.y, y)
        if not self.cached:
            self._run("step")
            return self.x
        if front is None:
            self._run("full")
        else:
            if self.front is None:
                raise ValueError("the block cache's partial step needs a full step's front first")
            _put(self.front, front)
            self._run("partial")
        return self.x, self.front

    def _run(self, name: str) -> None:
        graph = self._program(name)
        captures = graph.captures
        graph()
        self.captures += graph.captures - captures

    def release(self) -> None:
        """Drop the graphs, their memory and the static buffers."""
        for graph in self.graphs.values():
            graph.release()
        self.graphs, self.key = {}, None
        self.x = self.t = self.noise = self.y = self.front = None
