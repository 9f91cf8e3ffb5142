#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (latte_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure ends the script with a
non-zero exit and a traceback:

1. device: the card's name and power limit (nvidia-smi);
2. build: the kernel library, one nvcc process per latte_tpu_torch/csrc/*.cu
   source, all at once, then one link;
3. kernels: each forward CUDA kernel against its plain PyTorch version in
   bf16 at the sampler's spatial and temporal shapes, with its time, the
   plain version's, the bound from its bytes and operations and, for
   attention, the time of torch's scaled_dot_product_attention as a
   yardstick; then the attention's logsumexp output, and each kernel in fp32
   at the spatial shape. Then the two flash-attention backward kernels (dQ,
   dK/dV) the same way, in bf16 at both shapes, in fp32 at the spatial shape
   and in fp32 at the training config's batch 5 (spatial and temporal), with
   the backward of scaled_dot_product_attention as the yardstick;
4. forward: full-width Latte-XL/2 (16 x 256^2, bf16, random weights from a
   seed), kernel path against the plain path and an fp32 plain path, and the
   launch counts of one forward;
5. sampler: the entry point ``latte_tpu_torch.sample.sample.main`` on
   configs/ffs/ffs_sample.yaml with DDIM-50 at batch 1 from a random
   checkpoint, then DDPM for a few steps; finite latents, launch counts,
   videos/min, and the DDIM latents against the plain path's;
6. train: (a) one full-width train step (fp32, batch 1, gradient
   checkpointing) on the kernel path against the plain path from the same
   weights, t and noise, and the same in mixed precision; (b) the entry
   point ``latte_tpu_torch.train.train.main`` on configs/ffs/ffs_train.yaml
   as shipped (fp32, batch 5, synthetic latents) for a few steps, with its
   launch counts, seconds per step, peak memory and a profile of the last step,
   then a resume from its checkpoint and a short DDIM run of the port's
   sampler on the trained EMA; (c) two steps with mixed_precision: true.

Prints the kernels' JSON line and ends with
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs a GPU: without one it exits non-zero and prints no result. What
it writes (checkpoints, latents) goes to a temporary directory, the kernel
library to the git-ignored build/.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from latte_tpu_torch.config import load_config
from latte_tpu_torch.core.diffusion import create_diffusion
from latte_tpu_torch.kernels import (
    attention_bwd_dkv_reference,
    attention_bwd_dq_reference,
    attention_delta,
    attention_reference,
    build,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    ln_modulate,
    ln_modulate_reference,
    residual_ln_modulate,
    residual_ln_modulate_reference,
)
from latte_tpu_torch.models import get_model
from latte_tpu_torch.sample import sample
from latte_tpu_torch.train import train
from latte_tpu_torch.train.callbacks import Callback

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
TRAIN_BATCH, TRAIN_STEPS = 5, 6  # ffs_train.yaml's local_batch_size; steps of the entry-point run
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
    "flash_attention_bwd_dq": dict(
        source="latte_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="latte_tpu/kernels/attention.py:143",
        fn=flash_attention_bwd_dq,
    ),
    "flash_attention_bwd_dkv": dict(
        source="latte_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="latte_tpu/kernels/attention.py:184",
        fn=flash_attention_bwd_dkv,
    ),
}
FORWARD = ("flash_attention", "ln_modulate", "residual_ln_modulate")
BACKWARD = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# launches of each kernel in one train step with gradient checkpointing:
# every forward kernel twice per block (forward and recompute), each
# backward kernel once per block
STEP_LAUNCHES = {**{k: 2 * DEPTH for k in FORWARD}, **{k: DEPTH for k in BACKWARD}}
# (rows of the block, tokens per row) on the main path at batch 1
SHAPES = {"spatial": (FRAMES, TOKENS), "temporal": (TOKENS, FRAMES)}
# the backward kernels' cases: (rows, tokens, dtype); the last two are the
# training config's (batch 5, fp32), the shapes of the JSON line
BWD_SHAPES = {
    "spatial": (FRAMES, TOKENS, torch.bfloat16),
    "temporal": (TOKENS, FRAMES, torch.bfloat16),
    "spatial_fp32": (FRAMES, TOKENS, torch.float32),
    "spatial_b5_fp32": (TRAIN_BATCH * FRAMES, TOKENS, torch.float32),
    "temporal_b5_fp32": (TRAIN_BATCH * TOKENS, FRAMES, torch.float32),
}
ROOT = os.path.dirname(os.path.abspath(__file__))
FFS_CONFIG = os.path.join(ROOT, "configs", "ffs", "ffs_sample.yaml")
FFS_TRAIN = os.path.join(ROOT, "configs", "ffs", "ffs_train.yaml")


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


def backward_cases(rows: int, n: int, device, gen, dtype):
    """The dQ and dK/dV kernels at one shape: q/k/v are views of one fused
    qkv output and dq/dk/dv views of one fused gradient, as in the model;
    lse and delta come from the forward's plain version. The yardstick is
    the backward of torch's SDPA on the same q, k, v and dO (it computes
    dq, dk and dv together, so both rows carry the same time)."""
    kw = dict(device=device, dtype=dtype)
    qkv = torch.randn((rows, n, 3, HEADS, HEAD_DIM), generator=gen, **kw)
    q, k, v = qkv.unbind(2)
    dout = torch.randn((rows, n, HEADS, HEAD_DIM), generator=gen, **kw)
    out, lse = attention_reference(q, k, v, return_lse=True)
    delta = attention_delta(out, dout)
    dq, dk, dv = torch.empty_like(qkv).unbind(2)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in leaves))
    dout_t = dout.transpose(1, 2)
    e, bh = qkv.element_size(), rows * HEADS
    el = bh * n * HEAD_DIM  # elements of one of q, k, v, dO
    reads = 4 * el * e + 2 * bh * n * 4  # q, k, v, dO and the fp32 lse, delta
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    library = lambda: torch.autograd.grad(sdpa_out, leaves, dout_t, retain_graph=True)  # noqa: E731
    return {
        "flash_attention_bwd_dq": dict(
            run=lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta, dq),
            plain=lambda: attention_bwd_dq_reference(q, k, v, lse, dout, delta),
            library=library,
            bound=bound_ms(reads + el * e, 6 * bh * n * n * HEAD_DIM, rate),
        ),
        "flash_attention_bwd_dkv": dict(
            run=lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta, dk, dv),
            plain=lambda: attention_bwd_dkv_reference(q, k, v, lse, dout, delta),
            library=library,
            bound=bound_ms(reads + 2 * el * e, 8 * bh * n * n * HEAD_DIM, rate),
        ),
    }


def measure(name: str, label: str, case: dict, tol_rel: float, timer) -> dict:
    """Check one kernel case against its plain version, then time both."""
    got, want = case["run"](), case["plain"]()
    torch.cuda.synchronize()
    err, tol = max_err(got, want), tol_rel * max_abs(want)
    r = dict(
        max_abs_err=err,
        tolerance=tol,
        ms=timer.ms(case["run"]),
        plain_ms=timer.ms(case["plain"]),
        library_ms=timer.ms(case["library"]) if case["library"] else None,
        bound_ms=case["bound"][0],
        bound_by=case["bound"][1],
    )
    print(f"  {name} {label}: " + json.dumps(r), flush=True)
    if not err <= tol:
        raise AssertionError(f"{name} {label}: max abs err {err} > {tol}")
    return r


def check_kernels(device, timer) -> dict:
    """Each forward kernel against its plain version in bf16 at both shapes
    (and the attention's lse), then in fp32; then the backward kernels at
    BWD_SHAPES. Returns the measurements by kernel and shape."""
    gen = torch.Generator(device=device).manual_seed(0)
    results = {name: {} for name in KERNELS}
    for shape, (rows, n) in SHAPES.items():
        for name, case in kernel_cases(rows, n, device, gen).items():
            results[name][shape] = measure(name, f"{shape} rows={rows} N={n}", case, BF16_TOL, timer)
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
    for shape, (rows, n, dtype) in BWD_SHAPES.items():
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        for name, case in backward_cases(rows, n, device, gen, dtype).items():
            label = f"{shape} B*H={rows * HEADS} N={n}"
            results[name][shape] = measure(name, label, case, tol, timer)
        torch.cuda.empty_cache()
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
    """Relative L2 error and cosine of two tensors, summed in fp64 chunks
    (a gradient vector has 675M elements: an fp32 sum would drift)."""
    got, want = got.float().flatten(), want.float().flatten()
    dot = gg = ww = dd = 0.0
    for a, b in zip(got.split(1 << 24), want.split(1 << 24)):
        a, b = a.double(), b.double()
        dot += torch.dot(a, b).item()
        gg += torch.dot(a, a).item()
        ww += torch.dot(b, b).item()
        dd += torch.dot(a - b, a - b).item()
    r = dict(
        rel_l2=(dd / ww) ** 0.5,
        cosine=dot / (gg * ww) ** 0.5,
        finite=bool(torch.isfinite(got).all()),
    )
    print(f"  {name}: " + json.dumps(r), flush=True)
    return r


def kernel_kind(name: str) -> str:
    name = name.lower()
    for key, kind in (
        ("flash_fwd_kernel", "flash_attention"),
        ("flash_bwd_dq_kernel", "flash_attention_bwd_dq"),
        ("flash_bwd_dkv_kernel", "flash_attention_bwd_dkv"),
        ("residual_ln_modulate_kernel", "residual_ln_modulate"),
        ("ln_modulate_kernel", "ln_modulate"),
    ):
        if key in name:
            return kind
    if any(g in name for g in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    if "multi_tensor" in name or "foreach" in name:
        return "optimizer_ema"
    return "other"


def device_ms_by_kind(prof) -> tuple:
    """Device time (ms) of a profile by kind of kernel, the time the device
    was busy (the union of the kernels' intervals), and the largest kernels
    outside the port's own and the matmuls. Annotation ranges are left out
    (they span kernels counted here), and a kernel reported twice with the
    same interval counts once."""
    kernels = {
        (ev.name, ev.time_range.start, ev.time_range.end)
        for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(ev, "is_user_annotation", False)
    }
    groups, others = {}, {}
    for name, start, end in kernels:
        kind, ms = kernel_kind(name), (end - start) / 1e3
        groups[kind] = groups.get(kind, 0.0) + ms
        if kind == "other":
            others[name[:60]] = others.get(name[:60], 0.0) + ms
    busy, last_end = 0.0, None
    for _, start, end in sorted(kernels, key=lambda k: k[1]):
        if last_end is None or start >= last_end:
            busy, last_end = busy + end - start, end
        elif end > last_end:
            busy, last_end = busy + end - last_end, end
    top = dict(sorted(others.items(), key=lambda kv: -kv[1])[:6])
    return groups, busy / 1e3, top


def print_profile(label: str, prof, wall_ms: float = None) -> None:
    groups, busy, top = device_ms_by_kind(prof)
    if not busy:
        print(f"  {label} profile: the profiler saw no device time (not measured)", flush=True)
        return
    line = f"  {label} profile ms by kind: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(groups.items())}) + f"; device busy {busy:.4f}"
    if wall_ms:
        line += f" of {wall_ms:.4f} ms wall (device idle {1 - busy / wall_ms:.4f})"
    print(line, flush=True)
    print(f"  {label} largest other kernels (ms): "
          + json.dumps({k: round(v, 4) for k, v in top.items()}), flush=True)


def profile_forward(model, x, t) -> None:
    """Device time of one forward by kind of kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x, t)
        torch.cuda.synchronize()
    print_profile("forward", prof)


class StepLog(Callback):
    """Records each logged step's host time and metrics (the loop syncs with
    the device at every log, so the gaps are step times), keeps the train
    state, and profiles the step after ``profile_after`` when given."""

    def __init__(self, profile_after: int = 0):
        self.records, self.state, self.profile_after, self.prof = [], None, profile_after, None

    def on_train_start(self, config, state, experiment_dir):
        self.state = state

    def on_log(self, step, metrics):
        self.records.append((step, time.perf_counter(), metrics["loss"], metrics["grad_norm"]))
        if self.profile_after and step == self.profile_after:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
        elif self.prof is not None and step == self.profile_after + 1:
            self.prof.stop()

    def step_seconds(self) -> list:
        return [b[1] - a[1] for a, b in zip(self.records, self.records[1:])]

    def finite(self) -> bool:
        return bool(self.records) and all(np.isfinite(r[2]) and np.isfinite(r[3]) for r in self.records)


def train_step_parity(device) -> dict:
    """Phase 6a: one full-width train step (fp32, batch 1, gradient
    checkpointing), kernel path against plain path from the same weights,
    batch, t and noise; then both in mixed precision."""
    arch = dict(input_size=32, num_frames=FRAMES, gradient_checkpointing=True)
    with torch.device(device):
        model = get_model("Latte-XL/2", **arch)
        plain = get_model("Latte-XL/2", plain=True, **arch)
    randomize_(model, seed=2)
    plain.load_state_dict(model.state_dict())
    gen = torch.Generator(device=device).manual_seed(3)
    x0 = torch.randn((1, FRAMES, 4, 32, 32), generator=gen, device=device)
    noise = torch.randn(x0.shape, generator=gen, device=device)
    t = torch.tensor([137], device=device)
    diffusion = create_diffusion("")

    def step(m, compute_dtype):
        m.compute_dtype = compute_dtype
        loss = diffusion.training_losses(m, x0, t, noise)["loss"].mean()
        loss.backward()
        g = torch.cat([p.grad.flatten() for p in m.parameters()])
        m.zero_grad(set_to_none=True)
        return loss.detach(), g

    reset_counts()
    loss_k, g_k = step(model, None)
    torch.cuda.synchronize()
    step_counts = counts()
    loss_p, g_p = step(plain, None)
    print(f"  launches in one train step: {step_counts}", flush=True)
    if step_counts != STEP_LAUNCHES:
        raise AssertionError(f"expected {STEP_LAUNCHES} launches in one step, got {step_counts}")
    loss_rel = abs((loss_k - loss_p) / loss_p).item()
    fp32 = compare("fp32 step: kernel grads vs plain grads", g_k, g_p)
    norms = dict(kernel=g_k.norm().item(), plain=g_p.norm().item())
    print(f"  fp32 step: loss {loss_k.item()} vs {loss_p.item()} (rel err {loss_rel}); "
          f"grad norms {norms}", flush=True)
    # fp32 on both paths: the plain path's own error is 0, so the rule of the
    # forward phase leaves 1e-3
    if not (fp32["finite"] and fp32["cosine"] >= 0.999 and fp32["rel_l2"] <= 1e-3 and loss_rel <= 1e-4):
        raise AssertionError("the kernel path's train step disagrees with the plain path's")
    _, g_km = step(model, torch.bfloat16)
    _, g_pm = step(plain, torch.bfloat16)
    vs32 = compare("mixed step: kernel grads vs plain fp32 grads", g_km, g_p)
    plain_vs32 = compare("mixed step: plain grads vs plain fp32 grads", g_pm, g_p)
    compare("mixed step: kernel grads vs plain grads", g_km, g_pm)
    # the kernels may add no more error than bf16 itself brings
    if not (vs32["finite"] and vs32["rel_l2"] <= 1.25 * plain_vs32["rel_l2"] + 1e-3):
        raise AssertionError("the kernel path's mixed-precision step disagrees with the plain path's")
    return dict(step_launches=step_counts, loss_rel_err=loss_rel, grad_cosine=fp32["cosine"],
                grad_rel_l2=fp32["rel_l2"], grad_norms=norms, mixed_rel_l2_vs_fp32=vs32["rel_l2"],
                mixed_plain_rel_l2_vs_fp32=plain_vs32["rel_l2"])


def train_entry_point(tmp: str, smi: str) -> dict:
    """Phase 6b: ``train.main`` on ffs_train.yaml as shipped, then a resume
    and the sampler on the trained EMA."""
    overrides = [f"results_dir={tmp}/results", f"max_train_steps={TRAIN_STEPS}", "log_every=1",
                 f"ckpt_every={TRAIN_STEPS}"]
    log = StepLog(profile_after=TRAIN_STEPS - 1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = train.main(load_config(FFS_TRAIN, overrides), callbacks=[log])  # on cuda by default
    torch.cuda.synchronize()
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    secs = log.step_seconds()
    print(f"  ffs_train fp32 batch {TRAIN_BATCH}: {out}; launches {launches}", flush=True)
    if out["final_step"] != TRAIN_STEPS or not log.finite():
        raise AssertionError(f"the training run failed: {out}, {log.records}")
    if any(launches[k] == 0 for k in KERNELS):
        raise AssertionError(f"a kernel of the training path never launched: {launches}")
    if launches != {k: TRAIN_STEPS * c for k, c in STEP_LAUNCHES.items()}:
        raise AssertionError(f"expected {TRAIN_STEPS} x {STEP_LAUNCHES} launches, got {launches}")
    log.state = None  # free the run's model, EMA and moments
    # the first gap follows step 1, whose launches warm up cuBLAS; the last
    # one ran under the profiler: the median is of the three between
    warm = secs[1:-1]
    s_step = sorted(warm)[len(warm) // 2]
    print(f"  step gaps (s): {secs}; median of the unprofiled warm ones {s_step:.4f} s/step "
          f"= {1 / s_step:.4f} steps/s; "
          f"peak memory {peak_gib:.3f} GiB on {smi}", flush=True)
    print_profile("train step", log.prof, secs[-1] * 1e3)

    ckpt = os.path.join(out["experiment_dir"], "checkpoints", f"{TRAIN_STEPS:07d}.pt")
    print(f"  checkpoint {os.path.getsize(ckpt) / 2**30:.3f} GiB; "
          f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB free in {tmp}", flush=True)
    class Resumed(StepLog):
        def on_train_start(self, config, state, experiment_dir):
            super().on_train_start(config, state, experiment_dir)
            shutil.rmtree(out["experiment_dir"])  # restored: keep one checkpoint on disk

    resumed_log = Resumed()
    resumed = train.main(load_config(FFS_TRAIN, [
        f"results_dir={tmp}/results", f"max_train_steps={TRAIN_STEPS + 1}", "log_every=1",
        f"resume_from_checkpoint={ckpt}",
    ]), callbacks=[resumed_log])
    print(f"  resumed from step {TRAIN_STEPS}: {resumed}", flush=True)
    if resumed["final_step"] != TRAIN_STEPS + 1 or [r[0] for r in resumed_log.records] != [TRAIN_STEPS + 1]:
        raise AssertionError("the resumed run did not carry the step counter on")
    if resumed_log.state.step != TRAIN_STEPS + 1 or not resumed_log.finite():
        raise AssertionError("the resumed run failed")
    resumed_log.state = None
    trained = os.path.join(resumed["experiment_dir"], "checkpoints", f"{TRAIN_STEPS + 1:07d}.pt")
    lat = torch.from_numpy(np.load(sample.main(load_config(FFS_CONFIG, [
        "sample_method=ddim", "num_sampling_steps=5", f"ckpt={trained}",
        f"save_video_path={tmp}/trained.mp4",
    ])))["latents"])
    print(f"  ddim-5 from the trained EMA: latents {tuple(lat.shape)} "
          f"finite={bool(torch.isfinite(lat).all())}", flush=True)
    if lat.shape != (1, FRAMES, 4, 32, 32) or not torch.isfinite(lat).all():
        raise AssertionError("the sampler on the trained EMA gave no finite latents")
    shutil.rmtree(resumed["experiment_dir"])
    return dict(launches=launches, s_per_step=s_step, steps_per_s=1 / s_step, step_seconds=secs,
                peak_gib=peak_gib)


def train_mixed_precision(tmp: str, smi: str) -> dict:
    """Phase 6c: two steps with mixed_precision: true; the fp32 masters,
    their gradients, the AdamW moments and the EMA stay fp32."""
    log = StepLog()
    torch.cuda.reset_peak_memory_stats()
    out = train.main(load_config(FFS_TRAIN, [
        f"results_dir={tmp}/results", "max_train_steps=2", "log_every=1", "mixed_precision=true",
    ]), callbacks=[log])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    state = log.state
    dtypes = {p.dtype for p in state.model.parameters()} | {p.dtype for p in state.ema.parameters()}
    dtypes |= {v.dtype for s in state.optimizer.state.values() for k, v in s.items() if k != "step"}
    secs = log.step_seconds()
    print(f"  mixed precision: {out}; compute {state.model.compute_dtype}, state dtypes {dtypes}; "
          f"step 2 {secs[-1]:.4f} s; peak memory {peak_gib:.3f} GiB on {smi}", flush=True)
    if out["final_step"] != 2 or not log.finite() or dtypes != {torch.float32}:
        raise AssertionError("the mixed-precision run failed or its state left fp32")
    if state.model.compute_dtype != torch.bfloat16:
        raise AssertionError("mixed_precision did not switch the compute to bf16")
    shutil.rmtree(out["experiment_dir"])
    return dict(s_step2=secs[-1], peak_gib=peak_gib)


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
    if any(per_forward[k] != DEPTH for k in FORWARD) or any(per_forward[k] for k in BACKWARD):
        raise AssertionError(f"expected {DEPTH} launches of each forward kernel, got {per_forward}")
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
        if any(main_launches[k] != DEPTH * 50 for k in FORWARD):
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
        if not torch.isfinite(lat).all() or any(ddpm_launches[k] != DEPTH * 5 for k in FORWARD):
            raise AssertionError("the DDPM path failed")
    del model, plain16
    torch.cuda.empty_cache()
    phase("sampler", t0)

    # 6. training
    t0 = time.perf_counter()
    parity = train_step_parity(device)
    torch.cuda.empty_cache()
    phase("train parity", t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        entry = train_entry_point(tmp, smi)
        torch.cuda.empty_cache()
        phase("train entry point", t0)
        t0 = time.perf_counter()
        mixed = train_mixed_precision(tmp, smi)
    phase("train mixed precision", t0)
    print("train: " + json.dumps(dict(parity=parity, entry_point=entry, mixed_precision=mixed),
                                  default=str), flush=True)

    kernels = []
    for name, k in KERNELS.items():
        if name in FORWARD:  # the sampler's path, at its shapes (bf16, batch 1)
            row, extra = measured[name]["spatial"], dict(
                shape="spatial bf16 batch 1", launches_train=entry["launches"][name],
                temporal=measured[name]["temporal"])
            launches = main_launches[name]
        else:  # the training path, at its shapes (fp32, batch 5)
            row, extra = measured[name]["spatial_b5_fp32"], dict(
                shape="spatial fp32 batch 5", temporal=measured[name]["temporal_b5_fp32"],
                bf16_spatial=measured[name]["spatial"], bf16_temporal=measured[name]["temporal"])
            launches = entry["launches"][name]
        kernels.append(dict(
            name=name, route="cuda", source=k["source"], replaces=k["replaces"],
            launches=launches, max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], **extra,
        ))
    print(f"total: {time.perf_counter() - t_all:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
