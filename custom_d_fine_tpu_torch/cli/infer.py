"""Folder inference: images or videos -> visualizations, YOLO-format txt
predictions, optional padded crops (PyTorch; counterpart of
custom_d_fine_tpu/cli/infer.py).

Parity target: reference src/dl/infer.py:87-235 (image folder + video support,
txt predictions as boxes or polygons, per-detection crops with padding,
labels.txt).
Usage: python -m custom_d_fine_tpu_torch.cli.infer [--config cfg]
       [--weights model.pt] [k=v ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import cv2
import numpy as np

from ..utils.logging import logger

IMG_EXT = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
VID_EXT = {".mp4", ".avi", ".mov", ".mkv"}


def _pad_box(box, pad_w, pad_h, w, h):
    x1, y1, x2, y2 = box
    pw = pad_w * (x2 - x1) if isinstance(pad_w, float) and pad_w < 1 else pad_w
    ph = pad_h * (y2 - y1) if isinstance(pad_h, float) and pad_h < 1 else pad_h
    return (max(int(x1 - pw), 0), max(int(y1 - ph), 0),
            min(int(x2 + pw), w), min(int(y2 + ph), h))


def infer_folder(model, src: Path, out: Path, label_to_name, to_crop=False,
                 paddings=None, task="detect"):
    from ..data.yolo import abs_xyxy_to_norm_cxcywh, write_yolo_labels
    from ..infer.model import mask_to_polygons
    from ..utils.vis import draw_detections

    out_vis = out / "images"
    out_txt = out / "labels"
    out_crops = out / "crops"
    for p in (out_vis, out_txt):
        p.mkdir(parents=True, exist_ok=True)

    files = sorted(p for p in src.iterdir() if p.suffix.lower() in IMG_EXT | VID_EXT)
    for f in files:
        if f.suffix.lower() in VID_EXT:
            cap = cv2.VideoCapture(str(f))
            writer = None
            i = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                det = model(frame)[0]
                vis = draw_detections(frame, det, label_to_name)
                if writer is None:
                    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
                    writer = cv2.VideoWriter(str(out_vis / f"{f.stem}_pred.mp4"),
                                             fourcc, 30, (frame.shape[1], frame.shape[0]))
                writer.write(vis)
                i += 1
            cap.release()
            if writer:
                writer.release()
            logger.info(f"{f.name}: {i} frames")
            continue

        img = cv2.imread(str(f))
        if img is None:
            continue
        det = model(img)[0]
        h, w = img.shape[:2]
        vis = draw_detections(img, det, label_to_name)
        cv2.imwrite(str(out_vis / f.name), vis)

        polys = None
        if task == "segment" and det.get("masks") is not None:
            polys = []
            for m in det["masks"]:
                cs = mask_to_polygons(m)
                poly = max(cs, key=len) if cs else None
                polys.append(poly / np.array([w, h], np.float32) if poly is not None else None)
        boxes_norm = abs_xyxy_to_norm_cxcywh(det["boxes"].reshape(-1, 4), h, w) \
            if len(det["boxes"]) else np.zeros((0, 4), np.float32)
        write_yolo_labels(out_txt / f"{f.stem}.txt", det["labels"], boxes_norm, polys)

        if to_crop and paddings:
            out_crops.mkdir(parents=True, exist_ok=True)
            for j, (box, lab) in enumerate(zip(det["boxes"], det["labels"])):
                x1, y1, x2, y2 = _pad_box(box, paddings["w"], paddings["h"], w, h)
                crop = img[y1:y2, x1:x2]
                if crop.size:
                    cv2.imwrite(str(out_crops / f"{f.stem}_{j}_{int(lab)}.jpg"), crop)

    (out / "labels.txt").write_text(
        "\n".join(f"{k}: {v}" for k, v in sorted(label_to_name.items())) + "\n"
    )
    logger.info(f"Inference done: {len(files)} files -> {out}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--weights", default=None, help="checkpoint path override")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    from ..infer.model import TorchModel
    from ..utils.config import load_config, resolve_experiment_dir

    cfg = load_config(args.config, args.overrides)
    t = cfg["train"]
    t["path_to_save"] = resolve_experiment_dir(t["path_to_save"])
    label_to_name = {int(k): v for k, v in t["label_to_name"].items()}
    weights = args.weights or str(Path(t["path_to_save"]) / "model.pt")
    model = TorchModel(
        weights, cfg["model_name"], len(label_to_name),
        img_size=tuple(t["img_size"]), task=cfg.get("task", "detect"),
        conf_thresh=t.get("conf_thresh", 0.5), keep_ratio=t.get("keep_ratio", False),
        device=t.get("device"),
    )
    infer_folder(
        model, Path(t["path_to_test_data"]), Path(t["infer_path"]), label_to_name,
        to_crop=cfg["infer"].get("to_crop", False),
        paddings=cfg["infer"].get("paddings"),
        task=cfg.get("task", "detect"),
    )


if __name__ == "__main__":
    main()
