"""Mislabel hunter: run the model on train+val, save ONLY false-positive and
false-negative crops as annotated images (PyTorch; counterpart of
custom_d_fine_tpu/cli/check_errors.py).

Parity target: reference src/dl/check_errors.py:60-261 (greedy class-aware IoU
matching, FP/FN-only crops to find annotation mistakes).
Usage: python -m custom_d_fine_tpu_torch.cli.check_errors [--config cfg] [k=v ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import cv2
import numpy as np


def find_errors(pred, gt, iou_thresh: float):
    """Greedy class-aware matching; returns (fp_idx, fn_idx)."""
    from ..eval.coco_map import _box_iou

    pb, pl = pred["boxes"], pred["labels"]
    gb, gl = gt["boxes"], gt["labels"]
    ious = _box_iou(pb, gb)
    same = pl[:, None] == gl[None, :]
    cand = np.argwhere((ious >= iou_thresh) & same)
    order = np.argsort(-ious[cand[:, 0], cand[:, 1]]) if len(cand) else []
    mp, mg = set(), set()
    for k in order:
        a, b = int(cand[k, 0]), int(cand[k, 1])
        if a in mp or b in mg:
            continue
        mp.add(a)
        mg.add(b)
    fp = [i for i in range(len(pb)) if i not in mp]
    fn = [j for j in range(len(gb)) if j not in mg]
    return fp, fn


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--weights", default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    from ..data.loader import read_split_csv
    from ..data.yolo import norm_xywh_to_abs_xyxy, parse_yolo_label_file
    from ..infer.model import TorchModel
    from ..utils.config import load_config, resolve_experiment_dir
    from ..utils.logging import logger
    from ..utils.vis import vis_one_box

    cfg = load_config(args.config, args.overrides)
    t = cfg["train"]
    t["path_to_save"] = resolve_experiment_dir(t["path_to_save"])
    label_to_name = {int(k): v for k, v in t["label_to_name"].items()}
    ds_root = Path(t["data_path"])
    out_root = Path(t["root"]) / "output" / "label_errors"
    weights = args.weights or str(Path(t["path_to_save"]) / "model.pt")

    model = TorchModel(
        weights, cfg["model_name"], len(label_to_name),
        img_size=tuple(t["img_size"]), conf_thresh=t.get("conf_thresh", 0.5),
        keep_ratio=t.get("keep_ratio", False), enable_nms=True, device=t.get("device"),
    )

    n_errors = 0
    for split in ("train", "val"):
        csv_path = ds_root / f"{split}.csv"
        if not csv_path.exists():
            continue
        for name in read_split_csv(csv_path):
            img = cv2.imread(str(ds_root / "images" / name))
            if img is None:
                continue
            h, w = img.shape[:2]
            det = model(img)[0]
            lp = ds_root / "labels" / f"{Path(name).stem}.txt"
            if lp.exists() and lp.stat().st_size > 1:
                bn, _ = parse_yolo_label_file(lp)
                gt = {"boxes": norm_xywh_to_abs_xyxy(bn[:, 1:5], h, w),
                      "labels": bn[:, 0].astype(int)}
            else:
                gt = {"boxes": np.zeros((0, 4), np.float32),
                      "labels": np.zeros((0,), int)}
            fp, fn = find_errors(det, gt, t.get("iou_thresh", 0.5))
            if not fp and not fn:
                continue
            vis = img.copy()
            for i in fp:
                vis_one_box(vis, det["boxes"][i], det["labels"][i],
                            float(det["scores"][i]), "pred", label_to_name)
            for j in fn:
                vis_one_box(vis, gt["boxes"][j], gt["labels"][j], None, "gt",
                            label_to_name)
            save = out_root / split / name
            save.parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(save), vis)
            n_errors += 1
    logger.info(f"Saved {n_errors} images with FP/FN to {out_root}")


if __name__ == "__main__":
    main()
