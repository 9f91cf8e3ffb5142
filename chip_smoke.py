#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (latte_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure ends the script with a
non-zero exit and a traceback:

1. device: the card's name and power limit (nvidia-smi);
2. build: the kernel library, one nvcc call over latte_tpu_torch/csrc/*.cu;
3. kernels: each CUDA kernel against its plain PyTorch version in bf16 at the
   sampler's spatial and temporal shapes, with its time, the plain version's,
   the bound from its bytes and operations and, for attention, the time of
   torch's scaled_dot_product_attention as a yardstick; then the
   attention's logsumexp output, and each kernel in fp32 at the spatial shape;
4. forward: full-width Latte-XL/2 (16 x 256^2, bf16, random weights from a
   seed), kernel path against the plain path and an fp32 plain path, and the
   launch counts of one forward;
5. sampler: the entry point ``latte_tpu_torch.sample.sample.main`` on
   configs/ffs/ffs_sample.yaml with DDIM-50 at batch 1 from a random
   checkpoint, then DDPM for a few steps; finite latents, launch counts,
   videos/min, and the DDIM latents against the plain path's.

Prints the kernels' JSON line and ends with
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs a GPU: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from latte_tpu_torch.config import load_config
from latte_tpu_torch.kernels import (
    attention_reference,
    build,
    flash_attention,
    ln_modulate,
    ln_modulate_reference,
    residual_ln_modulate,
    residual_ln_modulate_reference,
)
from latte_tpu_torch.models import get_model
from latte_tpu_torch.sample import sample

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense tensor-core bf16
FP32_FLOP_PER_S = 67e12     # CUDA-core fp32
# bf16 keeps 8 significant bits: a result may differ from the plain version
# by one rounding step, 2^-7 of the largest magnitude; allow two
BF16_TOL = 2.0**-6
# fp32: the same arithmetic summed in another order, a few ulp (~1e-6) apart
FP32_TOL = 1e-5
# the fp32 logsumexp (values of order 5) of the kernel and the plain version
LSE_TOL = 1e-4
HIDDEN, HEADS, HEAD_DIM, FRAMES, TOKENS, DEPTH = 1152, 16, 72, 16, 256, 28
KERNELS = {
    "flash_attention": dict(
        source="latte_tpu_torch/csrc/flash_attention.cu",
        replaces="latte_tpu/kernels/attention.py:56",
        fn=flash_attention,
    ),
    "ln_modulate": dict(
        source="latte_tpu_torch/csrc/adaln.cu",
        replaces="latte_tpu/kernels/adaln.py:49",
        fn=ln_modulate,
    ),
    "residual_ln_modulate": dict(
        source="latte_tpu_torch/csrc/adaln.cu",
        replaces="latte_tpu/kernels/adaln.py:59",
        fn=residual_ln_modulate,
    ),
}
# (rows of the block, tokens per row) on the main path at batch 1
SHAPES = {"spatial": (FRAMES, TOKENS), "temporal": (TOKENS, FRAMES)}
FFS_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "ffs", "ffs_sample.yaml")


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0


def counts() -> dict:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


class Timer:
    """Median device time of a call, each launch after a write of 64 MB so
    the 50 MB L2 holds none of its inputs (CUDA events around the call only)."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 15) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]


def bound_ms(nbytes: float, flops: float, flop_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    return (a.float() - b.float()).abs().max().item()


def max_abs(a) -> float:
    if isinstance(a, tuple):
        return max(max_abs(x) for x in a)
    return a.float().abs().max().item()


def kernel_cases(rows: int, n: int, device, gen, dtype=torch.bfloat16):
    """Inputs at one main-path shape, laid out as the model hands them over:
    q/k/v are views of one fused qkv output, the adaLN vectors column chunks
    of one modulation output."""
    kw = dict(device=device, dtype=dtype)
    qkv = torch.randn((rows, n, 3, HEADS, HEAD_DIM), generator=gen, **kw)
    q, k, v = qkv.unbind(2)
    x = torch.randn((rows, n, HIDDEN), generator=gen, **kw)
    delta = torch.randn((rows, n, HIDDEN), generator=gen, **kw)
    mod = torch.randn((rows, 6 * HIDDEN), generator=gen, **kw)
    shift, scale, gate = mod[:, :HIDDEN], mod[:, HIDDEN:2 * HIDDEN], mod[:, 2 * HIDDEN:3 * HIDDEN]
    e, el = x.element_size(), rows * n * HIDDEN  # bytes per element, elements of one activation
    att_bytes = 4 * rows * n * HEADS * HEAD_DIM * e
    att_flops = 4 * rows * HEADS * n * n * HEAD_DIM
    return {
        "flash_attention": dict(
            run=lambda: flash_attention(q, k, v),
            plain=lambda: attention_reference(q, k, v),
            library=lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            ),
            bound=bound_ms(att_bytes, att_flops, BF16_FLOP_PER_S),
            lse=(
                lambda: flash_attention(q, k, v, return_lse=True)[1],
                lambda: attention_reference(q, k, v, return_lse=True)[1],
            ),
        ),
        "ln_modulate": dict(
            run=lambda: ln_modulate(x, shift, scale),
            plain=lambda: ln_modulate_reference(x, shift, scale),
            library=None,
            bound=bound_ms((2 * el + 2 * rows * HIDDEN) * e, 8 * el, FP32_FLOP_PER_S),
        ),
        "residual_ln_modulate": dict(
            run=lambda: residual_ln_modulate(x, delta, gate, shift, scale),
            plain=lambda: residual_ln_modulate_reference(x, delta, gate, shift, scale),
            library=None,
            bound=bound_ms((4 * el + 3 * rows * HIDDEN) * e, 11 * el, FP32_FLOP_PER_S),
        ),
    }


def check_kernels(device, timer) -> dict:
    """Each kernel against its plain version in bf16 at both shapes (and the
    attention's lse), then in fp32; returns the bf16 measurements by kernel
    and shape."""
    gen = torch.Generator(device=device).manual_seed(0)
    results = {name: {} for name in KERNELS}
    for shape, (rows, n) in SHAPES.items():
        for name, case in kernel_cases(rows, n, device, gen).items():
            got, want = case["run"](), case["plain"]()
            torch.cuda.synchronize()
            err, tol = max_err(got, want), BF16_TOL * max_abs(want)
            r = dict(
                max_abs_err=err,
                tolerance=tol,
                ms=timer.ms(case["run"]),
                plain_ms=timer.ms(case["plain"]),
                library_ms=timer.ms(case["library"]) if case["library"] else None,
                bound_ms=case["bound"][0],
                bound_by=case["bound"][1],
            )
            results[name][shape] = r
            print(f"  {name} {shape} rows={rows} N={n}: " + json.dumps(r), flush=True)
            if not err <= tol:
                raise AssertionError(f"{name} {shape}: max abs err {err} > {tol}")
            if "lse" in case:
                lse_err = max_err(case["lse"][0](), case["lse"][1]())
                print(f"  {name} {shape} lse: max abs err {lse_err} (tolerance {LSE_TOL})")
                if not lse_err <= LSE_TOL:
                    raise AssertionError(f"{name} {shape}: lse err {lse_err} > {LSE_TOL}")
    # the fp32 instantiations (the sampler with use_fp16: false)
    rows, n = SHAPES["spatial"]
    for name, case in kernel_cases(rows, n, device, gen, torch.float32).items():
        got, want = case["run"](), case["plain"]()
        err, tol = max_err(got, want), FP32_TOL * max_abs(want)
        print(f"  {name} spatial fp32: max abs err {err} (tolerance {tol})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name} fp32: max abs err {err} > {tol}")
    return results


def randomize_(model, seed: int) -> None:
    """Weights ~ N(0, 1/fan_in) and biases ~ N(0, 0.1²) from a seed, so every
    block (adaLN-Zero starts as the identity) and the output layer carry
    signal."""
    gen = torch.Generator(device=model.pos_embed.device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            std = (p[0].numel() ** -0.5) if p.dim() > 1 else 0.1
            p.normal_(0.0, std, generator=gen)


def compare(name: str, got, want) -> dict:
    got, want = got.float().flatten(), want.float().flatten()
    r = dict(
        rel_l2=((got - want).norm() / want.norm()).item(),
        cosine=F.cosine_similarity(got, want, dim=0).item(),
        finite=bool(torch.isfinite(got).all()),
    )
    print(f"  {name}: " + json.dumps(r), flush=True)
    return r


def profile_forward(model, x, t) -> None:
    """Device time of one forward by kind of kernel (torch.profiler), and the
    largest kernels outside the port's own."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x, t)
        torch.cuda.synchronize()
    groups, others = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0)
        if not us or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        if "flash_fwd_kernel" in name:
            kind = "flash_attention"
        elif "residual_ln_modulate_kernel" in name:
            kind = "residual_ln_modulate"
        elif "ln_modulate_kernel" in name:
            kind = "ln_modulate"
        elif any(g in name for g in ("gemm", "nvjet", "cutlass", "xmma")):
            kind = "matmul"
        else:
            kind = "other"
            others[ev.key[:60]] = us / 1e3
        groups[kind] = groups.get(kind, 0.0) + us / 1e3
    total = sum(groups.values())
    if not total:
        print("  profile: the profiler saw no device time (not measured)", flush=True)
        return
    print("  profile ms by kind: " + json.dumps({k: round(v, 4) for k, v in sorted(groups.items())})
          + f" total {total:.4f}", flush=True)
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    print("  largest other kernels (ms): " + json.dumps({k: round(v, 4) for k, v in top}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    device = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} (count {count}); torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    phase("device", t0)

    t0 = time.perf_counter()
    path = build.build()
    build.load_library()
    print(f"  library {path.name}, built in {time.perf_counter() - t0:.2f} s", flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    timer = Timer(device)
    measured = check_kernels(device, timer)
    phase("kernels", t0)

    # 4. one full-width forward: kernel path against plain paths
    t0 = time.perf_counter()
    arch = dict(input_size=32, num_frames=FRAMES)
    with torch.device(device):
        model = get_model("Latte-XL/2", **arch)
        plain32 = get_model("Latte-XL/2", plain=True, **arch)
    randomize_(model, seed=0)
    plain32.load_state_dict(model.state_dict())
    model.to(torch.bfloat16).eval()
    plain32.eval()
    with torch.device(device):
        plain16 = get_model("Latte-XL/2", plain=True, **arch)
    plain16.load_state_dict(model.state_dict())
    plain16.to(torch.bfloat16).eval()
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((1, FRAMES, 4, 32, 32), generator=gen, device=device)
    t = torch.tensor([500], device=device)
    with torch.inference_mode():
        model(x, t)  # warm-up: cuBLAS handles, first launches
        torch.cuda.synchronize()
        reset_counts()
        out_k = model(x, t)
        torch.cuda.synchronize()
        per_forward = counts()
        out_p16, out_p32 = plain16(x, t), plain32(x, t)
    print(f"  launches in one forward: {per_forward}", flush=True)
    if any(c != DEPTH for c in per_forward.values()):
        raise AssertionError(f"expected {DEPTH} launches of each kernel, got {per_forward}")
    if out_k.shape != (1, FRAMES, 8, 32, 32):
        raise AssertionError(f"forward shape {tuple(out_k.shape)}")
    vs_plain = compare("kernel bf16 vs plain bf16", out_k, out_p16)
    vs32 = compare("kernel bf16 vs plain fp32", out_k, out_p32)
    plain_vs32 = compare("plain bf16 vs plain fp32", out_p16, out_p32)
    # the kernels may add no more error than bf16 itself brings
    if not (vs_plain["finite"] and vs_plain["cosine"] >= 0.999
            and vs32["rel_l2"] <= 1.25 * plain_vs32["rel_l2"] + 1e-3):
        raise AssertionError("the kernel path disagrees with the plain path")
    with torch.inference_mode():
        fwd_ms = timer.ms(lambda: model(x, t), iters=5)
        plain_fwd_ms = timer.ms(lambda: plain16(x, t), iters=5)
        profile_forward(model, x, t)
    print(f"  forward ms: kernels {fwd_ms:.3f}, plain {plain_fwd_ms:.3f}", flush=True)
    del plain32
    phase("forward", t0)

    # 5. the entry point, from a checkpoint of the same random weights
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "latte_xl2_random.pt")
        torch.save({"ema": model.state_dict()}, ckpt)
        overrides = [
            "sample_method=ddim", "num_sampling_steps=50", "per_proc_batch_size=1",
            f"ckpt={ckpt}", f"save_video_path={tmp}/ffs.mp4",
        ]
        cfg = load_config(FFS_CONFIG, overrides)
        reset_counts()
        lat_path = sample.main(cfg)  # the entry point, on cuda by default
        main_launches = counts()
        lat = torch.from_numpy(np.load(lat_path)["latents"])
        print(f"  ddim-50 latents {tuple(lat.shape)} finite={bool(torch.isfinite(lat).all())}; "
              f"launches {main_launches}", flush=True)
        if lat.shape != (1, FRAMES, 4, 32, 32) or not torch.isfinite(lat).all():
            raise AssertionError("the sampler's latents are not finite (1, 16, 4, 32, 32)")
        if any(c != DEPTH * 50 for c in main_launches.values()):
            raise AssertionError(f"expected {DEPTH * 50} launches each, got {main_launches}")

        t1 = time.perf_counter()
        ref = sample.sample_latents(plain16, cfg, device)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        if not compare("ddim-50 latents, entry point vs plain path", lat, ref.cpu())["cosine"] >= 0.99:
            raise AssertionError("the DDIM latents disagree with the plain path's")
        t1 = time.perf_counter()
        sample.sample_latents(model, cfg, device)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t1
        print(f"  ddim-50 batch 1: {kernel_s:.3f} s -> {60.0 / kernel_s:.3f} videos/min "
              f"(plain path {plain_s:.3f} s) on {smi}", flush=True)

        cfg = load_config(FFS_CONFIG, [
            "sample_method=ddpm", "num_sampling_steps=5", f"ckpt={ckpt}",
            f"save_video_path={tmp}/ffs_ddpm.mp4",
        ])
        reset_counts()
        lat = torch.from_numpy(np.load(sample.main(cfg))["latents"])
        ddpm_launches = counts()
        print(f"  ddpm-5 latents finite={bool(torch.isfinite(lat).all())}; "
              f"launches {ddpm_launches}", flush=True)
        if not torch.isfinite(lat).all() or any(c != DEPTH * 5 for c in ddpm_launches.values()):
            raise AssertionError("the DDPM path failed")
    phase("sampler", t0)

    kernels = []
    for name, k in KERNELS.items():
        sp, tp = measured[name]["spatial"], measured[name]["temporal"]
        kernels.append(dict(
            name=name, route="cuda", source=k["source"], replaces=k["replaces"],
            launches=main_launches[name], max_abs_err=sp["max_abs_err"], ms=sp["ms"],
            plain_ms=sp["plain_ms"], bound_ms=sp["bound_ms"], bound_by=sp["bound_by"],
            library_ms=sp["library_ms"], shape="spatial", temporal=tp,
        ))
    print(f"total: {time.perf_counter() - t_all:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
