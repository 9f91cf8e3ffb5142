"""Build and load the port's CUDA kernels.

Each source under ``latte_tpu_torch/csrc/`` is compiled by its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the objects
into one shared library with a plain C interface (no PyTorch headers, so
the build takes seconds), which :func:`load_library` opens with ``ctypes``.
ptxas reports each kernel's registers, shared memory and spills
(``-Xptxas=-v``); :func:`compile_log` returns what the build printed.
The library lands in ``build/latte_tpu_torch/`` at the root of the checkout,
named by a hash of the sources and flags, so an unchanged tree reuses it
and a changed one rebuilds.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "latte_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of each C entry point: pointers and the stream as c_void_p so
# ctypes does not cut them to 32 bits
_SIGNATURES = {
    "latte_flash_attention_fwd": (
        [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I] + [_I64] * 9 + [_F, _I, _P]
    ),
    # the bf16 tensor-core forward and the register-tiled fp32 one: the same arguments
    **{
        f"latte_flash_attention_fwd_{route}": [_P] * 5 + [_I] * 4 + [_I64] * 9 + [_F, _I, _P]
        for route in ("tc", "f32")
    },
    # the generic adaLN kernels and the vector ones: the same arguments
    **{
        f"latte_ln_modulate{route}": [_I, _P, _P, _P, _P, _I, _I, _I, _I64, _F, _I, _P]
        for route in ("", "_vec")
    },
    **{
        f"latte_residual_ln_modulate{route}": (
            [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I64, _F, _I, _P]
        )
        for route in ("", "_vec")
    },
    # dtype, q, k, v, dout, lse, delta, dq, dk, dv, B, N, H, D, strides[21], ...
    "latte_flash_attention_bwd_dq": (
        [_I] + [_P] * 9 + [_I] * 4 + [ctypes.POINTER(_I64), _F, _I, _P]
    ),
    "latte_flash_attention_bwd_dkv": (
        [_I] + [_P] * 9 + [_I] * 4 + [ctypes.POINTER(_I64), _F, _I, _P]
    ),
    # the bf16 tensor-core backward and the register-tiled fp32 one: the same arguments
    **{
        f"latte_flash_attention_bwd_{kind}_{route}": (
            [_I] + [_P] * 9 + [_I] * 4 + [ctypes.POINTER(_I64), _F, _I, _P]
        )
        for kind in ("dq", "dkv")
        for route in ("tc", "f32")
    },
    # dtype, pv_int8, q, k, v, scales, o, B, N, H, D, scale_block, strides[9], ...
    "latte_flash_attention_int8": (
        [_I, _I] + [_P] * 5 + [_I] * 5 + [ctypes.POINTER(_I64), _I, _P]
    ),
    # dtype, pv_int8, q, k, v, q_amax, k_amax, v_amax, o, B, N, H, D, scale_block, strides[9],
    # D^-1/2, ...
    "latte_flash_attention_int8_tc": (
        [_I, _I] + [_P] * 7 + [_I] * 5 + [ctypes.POINTER(_I64), _F, _I, _P]
    ),
}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):  # .cu and .cuh
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"liblatte_kernels_{_digest()}.so"


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile the library unless the current sources are already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    tmp = out.with_name(f"{tag}.tmp.so")
    jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(sources(), objs)]
    try:
        _run_all(jobs)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        out.with_suffix(".log").write_text("".join(
            f"== {src.name}\n{o.with_suffix('.log').read_text()}" for src, o in zip(sources(), objs)
        ))
    finally:
        for path in (*objs, *(o.with_suffix(".log") for o in objs), tmp.with_suffix(".log")):
            path.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def compile_log() -> str:
    """What nvcc and ptxas printed while building the current library, one
    section per source ("== name.cu")."""
    return library_path().with_suffix(".log").read_text()


def _run_all(cmds: list) -> None:
    """Run the nvcc commands at once (each writes its errors to a log beside
    its output) and wait for all; raise with the errors of any that failed."""
    procs = []
    for cmd in cmds:
        log = Path(cmd[cmd.index("-o") + 1]).with_suffix(".log")
        with open(log, "w") as f:
            procs.append((cmd, log, subprocess.Popen(cmd, stderr=f)))
    failed = [(cmd, log, p.wait()) for cmd, log, p in procs]
    failed = [(cmd, log, rc) for cmd, log, rc in failed if rc != 0]
    if failed:
        raise RuntimeError("\n".join(
            f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log.read_text()[-8000:]}"
            for cmd, log, rc in failed
        ))


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, open the library and declare every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
