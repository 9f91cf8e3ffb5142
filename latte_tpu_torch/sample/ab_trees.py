"""bf16 DDIM-50 videos/min, or fp32 train s/step, of two checkouts of this
repo, by one method, in alternating runs on one card.

    python3 latte_tpu_torch/sample/ab_trees.py BEFORE_DIR AFTER_DIR [--pairs 10] [--mode train]

Each directory is a checkout (``git archive`` of a commit, say). One worker
process per checkout imports that checkout's ``latte_tpu_torch``, builds its
kernels, makes Latte-XL/2 at 16 x 256^2 in bf16 with random weights from a
seed and holds it on the card. After one warm-up run each, the runs
alternate (before, after, after, before, ...), so a drift of the host's
speed falls on both. A run is ``sample.sample_latents`` with
configs/ffs/ffs_sample.yaml at DDIM-50, batch 1, timed on the host's clock
and ending in a synchronize: the method of ``chip_smoke.py``'s sampler
phase. With ``--mode train`` the worker holds configs/ffs/ffs_train.yaml's
model, AdamW and EMA (fp32, gradient checkpointing) instead, and a run is
one ``train.step.make_train_step`` step at batch 5 on fixed synthetic
latents, ending in the loss's copy to the host: ``chip_smoke.py``'s latent
trainer without its loader. Prints each run's seconds and attention
launches, the median videos/min (or s/step) of each checkout, the pairs the
second one won, the card's name and power limit, and a JSON line of the
same. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TAG = "AB "  # the workers' lines of the protocol; other output passes through


def _randomize(model, device) -> None:
    """chip_smoke.py's weights: N(0, 1/fan_in), biases N(0, 0.1^2), seed 0."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, p[0].numel() ** -0.5 if p.dim() > 1 else 0.1, generator=gen)


def _train_run(tree: str, device):
    """The ``--mode train`` run: one fp32 train step of ffs_train.yaml's
    model at batch 5, from the checkout's ``make_train_step``."""
    import torch

    from latte_tpu_torch.config import load_config
    from latte_tpu_torch.core.diffusion import create_diffusion
    from latte_tpu_torch.models import get_models
    from latte_tpu_torch.train.state import create_train_state, make_lr_schedule, make_optimizer
    from latte_tpu_torch.train.step import make_train_step

    cfg = load_config(os.path.join(tree, "configs", "ffs", "ffs_train.yaml"), [])
    with torch.device(device):
        model = get_models(cfg)
    _randomize(model, device)
    state = create_train_state(model, make_optimizer(model), make_lr_schedule(1e-4))
    step = make_train_step(create_diffusion("", diffusion_steps=1000))
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((int(cfg.local_batch_size), 16, 4, 32, 32), generator=gen, device=device)
    return lambda: float(step(state, {"latents": x}, gen)["loss"])


def worker(tree: str, mode: str) -> None:
    """Serve runs for the checkout at ``tree``: one line "run" in, one line
    of seconds and launch counts out."""
    sys.path[0] = tree  # in place of this script's directory
    os.chdir(tree)
    import torch

    from latte_tpu_torch.config import load_config
    from latte_tpu_torch.kernels import build, flash_attention
    from latte_tpu_torch.models import get_model
    from latte_tpu_torch.sample import sample

    build.build()
    build.load_library()
    device = torch.device("cuda", 0)
    if mode == "train":
        once = _train_run(tree, device)
    else:
        with torch.device(device):
            model = get_model("Latte-XL/2", input_size=32, num_frames=16)
        _randomize(model, device)
        model.to(torch.bfloat16).eval()
        cfg = load_config(os.path.join(tree, "configs", "ffs", "ffs_sample.yaml"), [
            "sample_method=ddim", "num_sampling_steps=50", "per_proc_batch_size=1",
        ])
        once = lambda: sample.sample_latents(model, cfg, device)  # noqa: E731

    def run() -> dict:
        launches = flash_attention.launches
        tc = getattr(flash_attention, "tc_launches", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        return dict(s=time.perf_counter() - t0, launches=flash_attention.launches - launches,
                    tc_launches=getattr(flash_attention, "tc_launches", 0) - tc)

    run()
    print(TAG + "ready", flush=True)
    for _ in sys.stdin:
        print(TAG + json.dumps(run()), flush=True)


def _reply(proc: subprocess.Popen) -> str:
    for line in proc.stdout:
        if line.startswith(TAG):
            return line[len(TAG):].strip()
        print(line, end="", flush=True)
    raise RuntimeError(f"worker {proc.args[-1]} ended (exit {proc.wait()})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs=2, metavar="DIR")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--mode", choices=("ddim", "train"), default="ddim")
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", t, args.mode],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for t in trees
    ]
    runs = {t: [] for t in trees}
    try:
        for proc in procs:
            _reply(proc)  # built and warmed up
        for i in range(args.pairs):
            for j in ((0, 1) if i % 2 == 0 else (1, 0)):
                procs[j].stdin.write("run\n")
                procs[j].stdin.flush()
                r = json.loads(_reply(procs[j]))
                runs[trees[j]].append(r)
                print(f"pair {i} {os.path.basename(trees[j])}: {json.dumps(r)}", flush=True)
    finally:
        for proc in procs:
            proc.stdin.close()
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
    secs = {t: [r["s"] for r in runs[t]] for t in trees}
    med = {t: statistics.median(v) for t, v in secs.items()}
    wins = sum(b < a for a, b in zip(secs[trees[0]], secs[trees[1]]))
    rate = (lambda s: dict(videos_per_min=60.0 / s)) if args.mode == "ddim" else \
        (lambda s: dict(s_per_step=s))
    result = dict(
        device=smi, pairs=args.pairs, mode=args.mode,
        trees={t: dict(seconds=secs[t], median_s=med[t], **rate(med[t]),
                       launches=runs[t][0]["launches"], tc_launches=runs[t][0]["tc_launches"])
               for t in trees},
        after_faster_in_pairs=wins,
    )
    for t in trees:
        print(f"{t}: median {med[t]:.4f} s {json.dumps(rate(med[t]))} "
              f"(runs {min(secs[t]):.4f}-{max(secs[t]):.4f} s)")
    print(f"{trees[1]} faster in {wins} of {args.pairs} pairs, on {smi}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main())
