"""CLI: write a serving artifact from a sampling config (port of
``latte_tpu/serve/export_aot.py``).

Usage::

    python -m latte_tpu_torch.serve.export_aot --config configs/ffs/ffs_sample.yaml \\
        --out ffs_xl.ltpu-aot [--batch 4] [--device cuda|cpu] [key=value ...]

No weights are materialized (see :mod:`latte_tpu_torch.serve.aot`): the
model is built with its parameters on the meta device and the step is
traced from fake tensors, so the export needs neither a checkpoint nor a
GPU; any ``ckpt`` in the config is ignored here (the serving host passes the
state dict at call time). ``--device`` (default ``cuda``) is the device the
artifact runs on. ``block_cache_interval`` / ``block_cache_pairs`` export
the block cache's two programs; ``quantized: static`` an int8 artifact that
takes the calibrated scales as part of its state dict; ``tensor_parallel``
N (or the config's key) one program every one of N processes loads.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

from latte_tpu_torch.config import Config, load_config
from latte_tpu_torch.serve.aot import AOT_SUFFIX, build_model_shapes, export_sampler, save_sampler
from latte_tpu_torch.utils import create_logger


def main(config: Config, out: str, batch: int = 1, device: str = "cuda",
         tensor_parallel: Optional[int] = None) -> str:
    """Export the configured sampler's step to ``out`` (``.ltpu-aot`` is
    appended when missing); returns the path."""
    from latte_tpu_torch.sample.sample import block_cache_interval, cache_pairs, check_config

    logger = create_logger()
    check_config(config)
    tp = int(tensor_parallel if tensor_parallel is not None else getattr(config, "tensor_parallel", 1) or 1)
    dtype = torch.bfloat16 if getattr(config, "use_fp16", False) else torch.float32
    t0 = time.perf_counter()
    model = build_model_shapes(config, dtype, tp)
    interval = block_cache_interval(config)
    bc = (cache_pairs(config, model.depth), interval) if interval else None
    programs, header = export_sampler(model, config, batch=batch, device=device, tensor_parallel=tp,
                                      block_cache=bc)
    if not out.endswith(AOT_SUFFIX):
        out += AOT_SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_sampler(out, programs, header)
    logger.info(
        f"exported {header['model']} {header['sample_method']}-{header['num_sampling_steps']} sampler "
        f"(batch {batch}, {header['dtype']}, {device}, block cache {header['block_cache']}, quantized "
        f"{header['quantized']}) -> {out}: {os.path.getsize(out)} bytes in {time.perf_counter() - t0:.2f} s"
    )
    return out


def cli(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default="cuda", help="the device the artifact runs on: cuda (default) or cpu")
    p.add_argument("--tensor_parallel", type=int, default=None,
                   help="a tp=N artifact (defaults to the config key)")
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    return main(load_config(a.config, a.overrides), a.out, batch=a.batch, device=a.device,
                tensor_parallel=a.tensor_parallel)


if __name__ == "__main__":
    cli()
