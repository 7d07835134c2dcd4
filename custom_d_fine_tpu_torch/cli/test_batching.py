"""Batch-size throughput sweep (reference src/dl/test_batching.py:16-60;
PyTorch counterpart of custom_d_fine_tpu/cli/test_batching.py): sweeps
batch 1..32 over N images through the serving graph, reports throughput and
latency per image. The clock is read after torch.cuda.synchronize() on the
card, so it counts the card's work.
Usage: python -m custom_d_fine_tpu_torch.cli.test_batching [--config cfg]
           [--weights model.pt] [--n-images N] [k=v ...]
"""

from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np

BATCH_SIZES = (1, 2, 4, 8, 16, 32)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--n-images", type=int, default=512)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    import torch

    from ..infer.model import TorchModel
    from ..utils.config import load_config, resolve_experiment_dir
    from ..utils.logging import logger

    cfg = load_config(args.config, args.overrides)
    t = cfg["train"]
    t["path_to_save"] = resolve_experiment_dir(t["path_to_save"])
    H, W = tuple(t["img_size"])
    runtime = TorchModel(args.weights, cfg["model_name"], len(t["label_to_name"]),
                         img_size=(H, W), smoke_test=False, device=t.get("device"))

    def sync():
        if runtime.device.type == "cuda":
            torch.cuda.synchronize(runtime.device)

    rng = np.random.default_rng(0)
    rows = []
    for bs in BATCH_SIZES:
        imgs = torch.from_numpy(rng.integers(0, 255, (bs, H, W, 3)).astype(np.uint8))
        imgs = imgs.to(runtime.device)
        runtime.infer(imgs)  # first call of this shape
        sync()
        n_batches = max(args.n_images // bs, 1)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            runtime.infer(imgs)
        sync()
        dt = time.perf_counter() - t0
        n_imgs = n_batches * bs
        rows.append({
            "batch_size": bs,
            "throughput_img_s": round(n_imgs / dt, 1),
            "latency_ms_per_img": round(dt / n_imgs * 1000, 2),
        })
        logger.info(str(rows[-1]))

    out_csv = Path(t["path_to_save"]) / "batching.csv"
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    try:
        from tabulate import tabulate

        print(tabulate([list(r.values()) for r in rows], headers=list(rows[0].keys())))
    except ImportError:
        print(rows)
    return rows


if __name__ == "__main__":
    main()
