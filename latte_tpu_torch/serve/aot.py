"""Ahead-of-time serving artifacts through ``torch.export`` (port of
``latte_tpu/serve/aot.py``).

One **denoising step** of the configured sampler is exported once: the
model, CFG's doubling and combine, and the DDIM or DDPM update with its
clip (:func:`latte_tpu_torch.sample.sample.sampler_step`, the live
sampler's own construction). The step takes the model's whole state dict as
an input, beside x, t and the step's noise (and y for a class-conditional
model): the weights stay out of the artifact, so one file serves every
checkpoint of an architecture, and export traces from fake tensors, so a
host without weights or a GPU can write an artifact for the card. The
model's fixed sincos tables and the diffusion's per-timestep tables are the
program's constants.

The timestep loop stays in the loader (:func:`load_sampler`): it draws each
step's noise from the caller's ``torch.Generator`` (or ``noise_schedule[t]``)
in the live loops' order (``core.samplers.run_steps``,
``core.block_cache.run_cached_steps``), so a DDPM artifact gives the live
sampler's latents from the same seed. (The JAX artifact scans inside its
blob and takes a PRNG key instead.) The loader replays the step program as
the live sampler's ``loop_mode: scan`` does, as a CUDA graph captured once
on static buffers (``core.step_graph.GraphedStep``; on the CPU the same
runner calls the program), which is the counterpart of the JAX artifact's
whole trajectory; a tensor-parallel artifact, whose step holds all-reduces,
runs the eager loop. With the block cache two programs are
exported: the full step, which also returns the front, and the partial step
from pair k; the loader runs the cached loop's schedule over them.

The kernels on the path are the custom ops of :mod:`latte_tpu_torch.kernels.ops`,
one node each in the graph; so a serving host needs the port's kernel
package and its built library (the JAX artifact needs no model code). An
artifact is for one device type (``torch.export`` bakes the device of every
factory call into the graph): exported for ``cuda``, it refuses a host
without a GPU.

File layout: the magic ``LTPUPT01``, a little-endian u32 header length, the
JSON header, then the ``torch.export.save`` bytes of each program in the
header's ``programs`` order, each of the length the header gives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import struct
import threading
from typing import Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode

from latte_tpu_torch.config import Config

__all__ = ["AOT_SUFFIX", "export_sampler", "save_sampler", "load_sampler", "build_model_shapes"]

AOT_SUFFIX = ".ltpu-aot"
_MAGIC = b"LTPUPT01"
_JAX_MAGIC = b"LTPUAOT1"  # latte_tpu/serve/aot.py's artifacts
TP_GROUP = "latte_tpu_torch.tp"  # the tp group's name in an exported graph
# factory calls that, without a device, land on the meta device while a
# model is built for its shapes alone (torch.tensor and as_tensor, which
# carry data, keep it on the CPU)
_FACTORIES = (torch.empty, torch.empty_strided, torch.zeros, torch.ones, torch.full,
              torch.rand, torch.randn, torch.randint)


class _MetaParameters(TorchFunctionMode):
    """Build modules without storage for their parameters and state-dict
    buffers; tables made from data stay real."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _FACTORIES and kwargs.get("device") is None:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


class _FakeCudaIndexing(TorchFunctionMode):
    """Basic indexing (ints, slices, None, ``...``, one int64 index tensor)
    of tensors through their view ops, and ``contiguous`` through ``clone``.
    PyTorch built without CUDA cannot run these two on a fake CUDA tensor
    (their bindings open a device guard), so an export for the card on such
    a host runs under this mode; the graph gets the ops they record
    themselves (slice, select, unsqueeze, clone), and ``index_select`` for
    a tensor index."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.contiguous:  # the same guard; what it records, a clone
            x, fmt = args[0], kwargs.get("memory_format", torch.contiguous_format)
            return x if x.is_contiguous(memory_format=fmt) else x.clone(memory_format=fmt)
        if func is not torch.Tensor.__getitem__:
            return func(*args, **kwargs)
        x, index = args
        index = index if isinstance(index, tuple) else (index,)
        covered = sum(1 for i in index if i is not None and i is not Ellipsis)
        dim = 0
        for i in index:
            if i is Ellipsis:
                dim += x.dim() - covered
            elif i is None:
                x, dim = x.unsqueeze(dim), dim + 1
            elif isinstance(i, bool) or not isinstance(i, (int, slice, torch.Tensor)):
                raise NotImplementedError(f"indexing with {i!r} while exporting for cuda without CUDA")
            elif isinstance(i, int):
                x = x.select(dim, i)
            elif isinstance(i, slice):
                x = torch.ops.aten.slice.Tensor(x, dim, i.start, i.stop, 1 if i.step is None else i.step)
                dim += 1
            elif i.dtype == torch.int64 and i.dim() == 1:
                x, dim = x.index_select(dim, i), dim + 1
            else:
                raise NotImplementedError(f"indexing with a {i.dtype} {tuple(i.shape)} tensor while exporting for cuda")
        return x


def _indexing_mode(device: str):
    """:class:`_FakeCudaIndexing` for an export for cuda on a host without
    CUDA, else nothing."""
    return _FakeCudaIndexing() if device == "cuda" and not torch.cuda.is_available() else contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class _ExportMesh:
    """What a tensor-parallel model reads of its mesh when it is built for
    export: the tp size, and for its group the name the exported graph's
    all-reduces carry until ``load_sampler`` puts the real group's there."""

    tp: int
    sp: int = 1
    pp: int = 1
    tp_group: str = TP_GROUP


def build_model_shapes(config: Config, dtype: torch.dtype, tensor_parallel: int = 1):
    """The configured serving model (``quantized`` and ``int8_attention`` as
    the sampler builds it) with every parameter and state-dict buffer on the
    meta device: the counterpart of JAX's ``jax.eval_shape`` of the init.
    Its fixed tables are real, cast to ``dtype`` as the live model's are.
    ``tensor_parallel`` N: one tp rank's part (every rank's has the same
    shapes), its all-reduces over the placeholder group ``TP_GROUP``."""
    from latte_tpu_torch.models import get_models
    from latte_tpu_torch.sample.sample import quantized_mode

    mesh = _ExportMesh(int(tensor_parallel)) if tensor_parallel > 1 else None
    with _MetaParameters():
        model = get_models(config, quantized=quantized_mode(config), mesh=mesh)
    return model.to(dtype=dtype).eval()


class _Step(torch.nn.Module):
    """The exported program: one step of :func:`sampler_step` over the
    model called through ``torch.func.functional_call`` with the state dict
    it is given. The model is not a submodule (its weights would land in
    the program's state dict); its non-state-dict buffers (the sincos
    tables) and the diffusion's tables are this module's constants."""

    def __init__(self, model, config: Config, kind: str):
        from latte_tpu_torch.core.diffusion import create_diffusion

        super().__init__()
        object.__setattr__(self, "model", model)
        self.config, self.kind = config, kind
        self.diffusion = create_diffusion(str(config.num_sampling_steps))
        persistent = set(model.state_dict())
        self.model_tables = {}
        for i, (name, buf) in enumerate(model.named_buffers()):
            if name not in persistent:
                self.register_buffer(f"model_table_{i}", buf, persistent=False)
                self.model_tables[name] = f"model_table_{i}"
        self.diffusion_tables = list(self.diffusion.tables())
        for name, table in self.diffusion.tables().items():
            self.register_buffer(f"diffusion_{name}", table, persistent=False)

    def forward(self, state, x, t, noise, y=None, front=None):
        from latte_tpu_torch.sample.sample import sampler_step

        device = x.device
        params = {**state, **{n: getattr(self, a).to(device) for n, a in self.model_tables.items()}}
        self.diffusion.place_tables(
            {n: getattr(self, f"diffusion_{n}").to(device) for n in self.diffusion_tables}, device)

        def apply(*args, **kwargs):
            return torch.func.functional_call(self.model, params, args, kwargs)

        step = sampler_step(apply, self.config, self.diffusion, self.model.depth)
        if self.kind == "step":
            return step(x, t, noise, y)
        out, new_front = step(x, t, noise, y, front)
        return (out, new_front) if self.kind == "full" else out


def _with_block_cache(config: Config, block_cache: Optional[Tuple[int, int]]) -> Config:
    cfg = Config(config.to_dict() if isinstance(config, Config) else dict(config))
    cfg.block_cache_interval, cfg.block_cache_pairs = (0, 0) if block_cache is None else (
        int(block_cache[1]), int(block_cache[0]))
    return cfg


def export_sampler(
    model,
    config: Config,
    *,
    batch: int = 1,
    device: str = "cuda",
    tensor_parallel: int = 1,
    block_cache: Optional[Tuple[int, int]] = None,
) -> Tuple[dict, dict]:
    """Export the configured sampler's step for ``model``.

    ``model`` may hold real weights or none (:func:`build_model_shapes`):
    export traces from fake tensors on ``device`` ("cuda" or "cpu"), so
    only the state dict's names, shapes and dtypes matter. ``block_cache``
    ``(k, n)`` exports the full and the partial step of the cached loop at
    pair k, interval n. ``tensor_parallel`` N: ``model`` is a tp rank's part
    (``build_model_shapes(..., tensor_parallel=N)``); the program is every
    rank's, each block's two all-reduces in it as functional collectives.
    Returns ``({name: ExportedProgram}, header)``.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from latte_tpu_torch.sample.sample import cfg_of, latent_shape, quantized_mode

    tp = int(tensor_parallel or 1)
    if int(getattr(model, "tp", 1)) != tp:
        raise ValueError(f"tensor_parallel={tp}: the model holds a tp={getattr(model, 'tp', 1)} part "
                         "(build_model_shapes(config, dtype, tensor_parallel))")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: an artifact is exported for 'cuda' or 'cpu'")
    cfg = _with_block_cache(config, block_cache)
    use_cfg, cfg_scale = cfg_of(cfg)
    z_shape = latent_shape(cfg, batch)
    x_shape = ((2 * batch,) if use_cfg else (batch,)) + tuple(z_shape[1:])
    takes_y = int(getattr(cfg, "extras", 1)) == 2
    state, params = model.state_dict(), dict(model.named_parameters())
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fake_state = {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in state.items()}
        # one fake tensor an input: export would take two arguments given one tensor for one
        x, noise = (torch.empty(x_shape, dtype=torch.float32, device=device) for _ in range(2))
        t = torch.empty(x_shape[:1], dtype=torch.int64, device=device)
        y = torch.empty(x_shape[:1], dtype=torch.int64, device=device) if takes_y else None
    kinds = ("step",) if block_cache is None else ("full", "partial")
    programs = {}
    with torch.no_grad(), _indexing_mode(device):
        for kind in kinds:
            args = (fake_state, x, t, noise, y)
            if kind == "partial":
                shape, dtype = _front_meta(programs["full"])
                with mode:
                    args += (torch.empty(shape, dtype=dtype, device=device),)
            ep = torch.export.export(_Step(model, cfg, kind), args, strict=False)
            ep.example_inputs = None  # fake tensors: nothing to keep
            programs[kind] = ep
    dtype = next((v.dtype for k, v in state.items() if v.is_floating_point() and "scale" not in k), torch.float32)
    header = {
        "format": 1,
        "model": str(getattr(cfg, "model", type(model).__name__)),
        "sample_method": str(getattr(cfg, "sample_method", "ddpm")).lower(),
        "num_sampling_steps": int(getattr(cfg, "num_sampling_steps", 250)),
        "cfg": bool(use_cfg),
        "cfg_scale": cfg_scale,
        "extras": int(getattr(cfg, "extras", 1)),
        "num_classes": int(getattr(model, "num_classes", 0) or 0),
        "batch": int(batch),
        "z_shape": list(z_shape),
        "takes_y": takes_y,
        "tensor_parallel": tp,
        "block_cache": None if block_cache is None else [int(block_cache[0]), int(block_cache[1])],
        "device": device,
        "dtype": str(dtype).removeprefix("torch."),
        "quantized": quantized_mode(cfg),
        "int8_attention": getattr(cfg, "int8_attention", False) or False,
        "torch": torch.__version__,
        # in the program's order (a dict argument's keys are matched in
        # order), and whether each is a parameter (see _place)
        "state": [[k, list(v.shape), str(v.dtype).removeprefix("torch."), k in params]
                  for k, v in state.items()],
    }
    return programs, header


def _front_meta(full) -> tuple:
    """(shape, dtype) of the full step's second output, the front."""
    node = [n for n in full.graph.nodes if n.op == "output"][0]
    val = node.args[0][1].meta["val"]
    return tuple(val.shape), val.dtype


def save_sampler(path: str, programs: dict, header: dict) -> str:
    """Write the artifact: magic | u32 header length | JSON header | programs."""
    blobs = {}
    for name, ep in programs.items():
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        blobs[name] = buf.getvalue()
    header = {**header, "programs": {name: len(b) for name, b in blobs.items()}}
    hdr = json.dumps(header, sort_keys=True).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        for name in sorted(blobs):  # the JSON header's (sorted) order, which read_artifact follows
            f.write(blobs[name])
    return path


def read_artifact(path: str) -> Tuple[dict, dict]:
    """The header and each program's bytes; raises ``ValueError`` for a
    JAX artifact and for any other file that is not one of the port's."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _JAX_MAGIC:
            raise ValueError(
                f"{path}: a JAX (jax.export) artifact of latte_tpu/serve/aot.py; the PyTorch port "
                "loads artifacts written by latte_tpu_torch.serve.export_aot"
            )
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a latte-tpu AOT artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode("utf-8"))
        blobs = {name: f.read(n) for name, n in header["programs"].items()}
    return header, blobs


def _place(state_dict: dict, spec: list, device: torch.device) -> dict:
    """The caller's state dict as the program takes it: every entry of the
    exported model's, in its order, on ``device`` in its exported dtype (as
    the live sampler's ``model.to(device, dtype)`` casts it), the model's
    parameters requiring grad as the live model's do. (That is not for a
    backward: ``at::matmul`` folds a strided 3-D input into one product or
    runs a batched one depending on it, and the live model's patch
    embedding takes the first way.)"""
    names = [name for name, _, _, _ in spec]
    missing, unexpected = sorted(set(names) - set(state_dict)), sorted(set(state_dict) - set(names))
    if missing or unexpected:
        raise KeyError(f"the state dict does not match the artifact's model: missing {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}, unexpected {unexpected[:5]}"
                       f"{' ...' if len(unexpected) > 5 else ''}")
    out = {}
    for name, shape, dtype, is_param in spec:
        t = state_dict[name]
        if list(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the artifact's model has {tuple(shape)}")
        t = t.to(device=device, dtype=getattr(torch, dtype))
        t = t.clone() if t.is_inference() else t.detach()  # never the caller's tensor object
        out[name] = t.requires_grad_(is_param)
    return out


def _drop_per_step_checks(module) -> None:
    """Erase what the export adds to check each call: the check of every
    input's shape (``call`` checks z, y and the state dict once per
    trajectory; the program's own check of its ~300 inputs took a third of
    a step's host time), and the asserts of each ``.to()``'s operand (the
    tables were CPU tensors when traced; the loader puts them on the
    serving device, where their ``.to(device)`` is then a no-op)."""
    for key, hook in list(module._forward_pre_hooks.items()):
        if getattr(hook, "__name__", "") == "_check_input_constraints_pre_hook":
            del module._forward_pre_hooks[key]
            module._forward_pre_hooks_with_kwargs.pop(key, None)
    for node in list(module.graph.nodes):
        if node.op == "call_function" and node.target is torch.ops.aten._assert_tensor_metadata.default:
            module.graph.erase_node(node)
    module.recompile()


def _name_tp_group(module, group_name: str) -> None:
    """Put the process group's name in the exported all-reduces, which
    carry ``TP_GROUP``'s."""
    n = 0
    for node in module.graph.nodes:
        if node.op == "call_function" and TP_GROUP in node.args:
            node.args = tuple(group_name if a == TP_GROUP else a for a in node.args)
            n += 1
    if not n:
        raise ValueError("a tensor-parallel artifact's program holds no all-reduce over its tp group")
    module.recompile()


def load_sampler(path: str):
    """Read an artifact; returns ``call(state_dict, z[, y], generator=None,
    noise_schedule=None)`` -> the final latents (B, F, C, L, L), fp32, on
    the header's device. ``call.header`` is the header, ``call.programs``
    the loaded programs, ``call.place(state_dict)`` the state dict as the
    programs take it (on the device, cast): a caller that serves many
    requests places it once and passes that.

    ``state_dict`` is the exported model's whole state dict (a checkpoint's
    EMA weights; for ``quantized: static`` the output of
    ``quant.quantize_params`` with the calibrated amax), in any dtype and on
    any device: it is moved and cast as the live sampler casts its model. z
    (and y) must have the exported batch; ``generator`` draws each step's
    noise as the live sampler does. The kernels' custom ops are registered
    (``latte_tpu_torch.kernels``) before the programs load.

    A ``tensor_parallel`` N artifact loads in each of the N processes of an
    initialized process group of world N (else ``ValueError``); each builds
    the (dp 1, tp N) mesh, and ``call`` takes the whole state dict and keeps
    the rank's Megatron part (``dist.sharding.tp_shard_state_dict``), as the
    live sampler does; every rank returns the latents.

    One process replays the step program as a CUDA graph (``call.graphed``,
    a ``core.step_graph.GraphedStep``), captured at the first call and
    again when the placed weights' addresses change: a caller that passes
    the same placed state dict replays. Calls from several threads take
    turns on it."""
    import latte_tpu_torch.kernels  # noqa: F401  (registers the custom ops)
    from latte_tpu_torch.core.diffusion import create_diffusion
    from latte_tpu_torch.core.step_graph import GraphedStep
    from latte_tpu_torch.sample.sample import cfg_batch, run_sampler

    header, blobs = read_artifact(path)
    device = torch.device(header["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for cuda, and this host has no CUDA device")
    tp = int(header.get("tensor_parallel", 1) or 1)
    dist = torch.distributed
    if tp > 1 and not (dist.is_available() and dist.is_initialized() and dist.get_world_size() == tp):
        raise ValueError(f"{path} was exported tensor_parallel={tp}: load it in each of {tp} processes "
                         f"of an initialized process group of world {tp}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ctx = None
    if tp > 1:  # every rank builds the (dp 1, tp N) mesh, as the live sampler does
        from latte_tpu_torch.dist.mesh import DistContext, MeshConfig, make_mesh

        ctx = DistContext(make_mesh(MeshConfig(dp=1, tp=tp), device.type), device)
    programs = {}
    for name, blob in blobs.items():
        ep = torch.export.load(io.BytesIO(blob))
        # the constants (sincos and diffusion tables) live on the serving device
        for key, value in list(ep.constants.items()):
            if isinstance(value, torch.Tensor):
                ep.constants[key] = value.to(device)
        module = ep.module()
        _drop_per_step_checks(module)
        if ctx is not None:
            _name_tp_group(module, ctx.tp_group.group_name)
        programs[name] = module
    diffusion = create_diffusion(str(header["num_sampling_steps"]))
    n, use_cfg = header["batch"], header["cfg"]
    bc = header["block_cache"]

    def stepper(placed: dict):
        """The loop's step over the programs, with this call's weights."""

        def step(x, t, noise, y, front=None):
            if "step" in programs:
                return programs["step"](placed, x, t, noise, y)
            if front is None:
                return programs["full"](placed, x, t, noise, y)
            return programs["partial"](placed, x, t, noise, y, front), front

        return step

    graphed, weights, lock = None, {}, threading.Lock()
    if ctx is None:
        graphed = GraphedStep(lambda *args: stepper(weights)(*args), cached=bc is not None,
                              weights=lambda: weights.values())

    def call(state_dict: dict, z: torch.Tensor, y: Optional[torch.Tensor] = None, *,
             generator: Optional[torch.Generator] = None, noise_schedule=None) -> torch.Tensor:
        if list(z.shape) != header["z_shape"]:
            raise ValueError(f"z has shape {tuple(z.shape)}; the artifact was exported for {tuple(header['z_shape'])}")
        if header["takes_y"] != (y is not None):
            raise ValueError("the artifact takes labels y" if header["takes_y"] else "the artifact takes no y")
        if ctx is not None:  # this rank's Megatron part, as the live sampler keeps it
            from latte_tpu_torch.dist.sharding import tp_shard_state_dict

            state_dict = tp_shard_state_dict(state_dict, tp, ctx.tp_rank)
        placed = _place(state_dict, header["state"], device)
        x = z.to(device=device, dtype=torch.float32)
        if y is not None:
            x, y = cfg_batch(use_cfg, header["num_classes"], x, y.to(device=device, dtype=torch.int64))
        kwargs = dict(interval=bc[1] if bc else 0, ddim=header["sample_method"] == "ddim", generator=generator,
                      noise_schedule=noise_schedule)
        with torch.inference_mode():
            if graphed is None:
                return run_sampler(stepper(placed), diffusion, x, y, **kwargs)[:n]
            with lock:
                weights.clear()
                weights.update(placed)
                try:
                    return run_sampler(graphed, diffusion, x, y, **kwargs)[:n].clone()
                finally:
                    weights.clear()

    call.header = header
    call.graphed = graphed
    call.programs = programs  # each program's module: (state, x, t, noise, y[, front]) -> ...
    call.place = lambda state_dict: _place(state_dict, header["state"], device)
    return call
