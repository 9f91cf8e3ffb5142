"""The metric CLI (port of ``latte_tpu/eval/calc_metrics.py``)::

    python -m latte_tpu_torch.eval.calc_metrics --real_data_path A --fake_data_path B \
        --metrics fvd2048_16f,fid50k_full [--device cpu]

The detectors run on ``--device``, the card unless named (without a GPU
it raises, as the sampler and the trainer do). Under torchrun (one process
a GPU) the processes share each batch's detector work and gather the
features; rank 0 prints and writes the records.
"""

from __future__ import annotations

import argparse
import json

from latte_tpu_torch.dist.mesh import initialize_distributed, is_main_process
from latte_tpu_torch.eval.metrics import calc_metric
from latte_tpu_torch.utils import resolve_device

_ROLE = {"fvd": "i3d", "isv": "c3d"}  # fid/kid/is -> inception


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--real_data_path", required=True)
    p.add_argument("--fake_data_path", required=True)
    p.add_argument("--metrics", default="fvd2048_16f")
    p.add_argument("--report_dir", default="./metrics_out")
    p.add_argument("--cache_dir", default=None)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--detector",
        default="auto",
        help="'auto' (the file in LATTE_TPU_DETECTORS), 'standin[:seed]' "
        "(deterministic projection detector — protocol validation only), or a torchscript file path",
    )
    p.add_argument("--max_real", type=int, default=None,
                   help="override the metric's real-item budget (e.g. reduced-clip runs)")
    p.add_argument("--max_fake", type=int, default=None, help="override the metric's fake-item budget")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    device = initialize_distributed(device=a.device) or resolve_device(a.device)

    records = []
    for name in a.metrics.split(","):
        name = name.strip()
        opts = dict(
            report_dir=a.report_dir,
            real_path=a.real_data_path,
            fake_path=a.fake_data_path,
            cache_dir=a.cache_dir,
            num_frames=a.num_frames,
            seed=a.seed,
            device=device,
        )
        if a.detector != "auto":
            from latte_tpu_torch.eval.detectors import get_detector

            role = next((r for pre, r in _ROLE.items() if name.startswith(pre)), "inception")
            opts["detector"] = get_detector(a.detector, role, device=device)
        if a.max_real is not None:
            opts["max_real"] = a.max_real
        if a.max_fake is not None:
            opts["max_fake"] = a.max_fake
        record = calc_metric(name, **opts)
        if is_main_process():
            print(json.dumps(record))
        records.append(record)
    return records


if __name__ == "__main__":
    main()
