"""Backend benchmark: run every precision variant over the val/test set with
per-image latency + F1, render predictions, tabulate + CSV (PyTorch;
counterpart of custom_d_fine_tpu/cli/bench.py).

Parity target: reference src/dl/bench.py:55-267 (per-backend latency with
warmup and device sync, F1 via Validator, visualizations, CSV + table). The
variants are the serving graph's (deploy/serving.py) on the card: float32,
bfloat16 (autocast) and int8 (per-channel weights dequantized in the graph,
deploy/quantize.py), rows named torch_<variant>. A call's latency ends with
the detections on the host, so it includes the card's work.
Usage: python -m custom_d_fine_tpu_torch.cli.bench [--config cfg]
       [--weights model.pt] [k=v ...]
"""

from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path
from typing import Dict, List

import cv2
import numpy as np

from ..utils.logging import logger


def test_model(model, ds_root: Path, names: List[str], label_to_name,
               conf_thresh: float, iou_thresh: float, vis_path: Path = None,
               n_warmup: int = 10, n_vis: int = 10):
    """Latency + metrics over one split (reference bench.py:55-158)."""
    from ..data.yolo import norm_xywh_to_abs_xyxy, parse_yolo_label_file
    from ..eval.validator import Validator
    from ..utils.vis import draw_detections

    # warmup (reference bench.py:81-86)
    warm = cv2.imread(str(ds_root / "images" / names[0]))
    for _ in range(n_warmup):
        model(warm)

    preds, gts, times = [], [], []
    for i, name in enumerate(names):
        img = cv2.imread(str(ds_root / "images" / name))
        if img is None:
            continue
        t0 = time.perf_counter()
        det = model(img)[0]
        times.append((time.perf_counter() - t0) * 1000)

        preds.append({
            "boxes": det["boxes"], "labels": det["labels"], "scores": det["scores"],
            "all_boxes": det["boxes"], "all_labels": det["labels"],
            "all_scores": det["scores"],
        })
        h, w = img.shape[:2]
        lp = ds_root / "labels" / f"{Path(name).stem}.txt"
        if lp.exists() and lp.stat().st_size > 1:
            bn, _ = parse_yolo_label_file(lp)
            gts.append({"boxes": norm_xywh_to_abs_xyxy(bn[:, 1:5], h, w),
                        "labels": bn[:, 0].astype(int)})
        else:
            gts.append({"boxes": np.zeros((0, 4), np.float32),
                        "labels": np.zeros((0,), int)})
        if vis_path and i < n_vis:
            vis_path.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(vis_path / name), draw_detections(img, det, label_to_name))

    v = Validator(gts, preds, label_to_name, conf_thresh=conf_thresh,
                  iou_thresh=iou_thresh)
    metrics = v.compute_metrics()
    metrics["latency_ms_p50"] = float(np.percentile(times, 50))
    metrics["latency_ms_mean"] = float(np.mean(times))
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--split", default="val")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    from ..data.loader import read_split_csv
    from ..infer.model import TorchModel
    from ..utils.config import load_config, resolve_experiment_dir

    cfg = load_config(args.config, args.overrides)
    t = cfg["train"]
    t["path_to_save"] = resolve_experiment_dir(t["path_to_save"])
    label_to_name = {int(k): v for k, v in t["label_to_name"].items()}
    ds_root = Path(t["data_path"])
    names = read_split_csv(ds_root / f"{args.split}.csv")
    weights = args.weights or str(Path(t["path_to_save"]) / "model.pt")

    rows = []
    for variant in ("float32", "bfloat16", "int8"):
        logger.info(f"Benchmarking {variant} ...")
        model = TorchModel(
            weights, cfg["model_name"], len(label_to_name),
            img_size=tuple(t["img_size"]), task=cfg.get("task", "detect"),
            conf_thresh=t.get("conf_thresh", 0.5),
            keep_ratio=t.get("keep_ratio", False), dtype=variant, device=t.get("device"),
        )
        m = test_model(
            model, ds_root, names, label_to_name,
            t.get("conf_thresh", 0.5), t.get("iou_thresh", 0.5),
            vis_path=Path(t.get("bench_img_path", "bench_imgs")) / variant,
        )
        m["backend"] = f"torch_{variant}"
        rows.append(m)
        logger.info(f"{variant}: f1={m['f1']:.4f} p50={m['latency_ms_p50']:.2f}ms")

    out_csv = Path(t["path_to_save"]) / "bench.csv"
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    keys = ["backend", "f1", "precision", "recall", "iou", "mAP_50", "mAP_50_95",
            "latency_ms_p50", "latency_ms_mean"]
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
        w.writeheader()
        for r in rows:
            w.writerow({k: r.get(k) for k in keys})
    try:
        from tabulate import tabulate

        print(tabulate([[r.get(k) for k in keys] for r in rows], headers=keys))
    except ImportError:
        print(rows)


if __name__ == "__main__":
    main()
