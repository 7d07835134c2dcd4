"""Dataset format converters (host code; a copy of
custom_d_fine_tpu/etl/converters.py).

Parity targets (reference src/etl/):
- coco2yolo.py:8-40 / yolo2coco.py:10-40 — COCO JSON <-> YOLO txt (boxes+segments)
- png_mask_to_yolo.py:10-45 — binary PNG masks -> YOLO polygons
- polys2bbox.py:16-41 — YOLO polygon labels -> YOLO bbox labels
- split_yolo_from_dfine.py / split_from_yolo.py — CSV splits <-> Ultralytics layout
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, List, Optional

import cv2
import numpy as np

IMG_EXT = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def coco_to_yolo(coco_json: Path, out_labels: Path) -> int:
    """COCO annotations -> per-image YOLO txt (boxes; segmentation polygons
    when present). Category ids are remapped to a dense 0..C-1 range."""
    data = json.loads(Path(coco_json).read_text())
    images = {im["id"]: im for im in data["images"]}
    cat_ids = sorted({c["id"] for c in data["categories"]})
    cat_map = {cid: i for i, cid in enumerate(cat_ids)}
    out_labels = Path(out_labels)
    out_labels.mkdir(parents=True, exist_ok=True)

    lines: Dict[int, List[str]] = {}
    for ann in data["annotations"]:
        im = images[ann["image_id"]]
        w, h = im["width"], im["height"]
        cls = cat_map[ann["category_id"]]
        seg = ann.get("segmentation")
        if seg and isinstance(seg, list) and len(seg) and len(seg[0]) >= 6:
            poly = np.asarray(seg[0], np.float32).reshape(-1, 2)
            poly[:, 0] /= w
            poly[:, 1] /= h
            coords = " ".join(f"{v:.6f}" for v in poly.reshape(-1))
            lines.setdefault(ann["image_id"], []).append(f"{cls} {coords}")
        else:
            x, y, bw, bh = ann["bbox"]
            cx, cy = (x + bw / 2) / w, (y + bh / 2) / h
            lines.setdefault(ann["image_id"], []).append(
                f"{cls} {cx:.6f} {cy:.6f} {bw / w:.6f} {bh / h:.6f}"
            )
    for img_id, ls in lines.items():
        stem = Path(images[img_id]["file_name"]).stem
        (out_labels / f"{stem}.txt").write_text("\n".join(ls) + "\n")
    return len(lines)


def yolo_to_coco(images_dir: Path, labels_dir: Path, out_json: Path,
                 label_to_name: Optional[Dict[int, str]] = None) -> int:
    """YOLO txt -> COCO JSON (boxes + polygon segments)."""
    from ..data.yolo import parse_yolo_label_file

    images_dir, labels_dir = Path(images_dir), Path(labels_dir)
    images, annotations = [], []
    classes = set()
    ann_id = 1
    for img_id, p in enumerate(sorted(images_dir.iterdir()), 1):
        if p.suffix.lower() not in IMG_EXT:
            continue
        img = cv2.imread(str(p))
        if img is None:
            continue
        h, w = img.shape[:2]
        images.append({"id": img_id, "file_name": p.name, "width": w, "height": h})
        lp = labels_dir / f"{p.stem}.txt"
        if not lp.exists() or lp.stat().st_size <= 1:
            continue
        boxes, polys = parse_yolo_label_file(lp)
        for b, poly in zip(boxes, polys):
            cls = int(b[0])
            classes.add(cls)
            cx, cy, bw, bh = float(b[1] * w), float(b[2] * h), float(b[3] * w), float(b[4] * h)
            ann = {
                "id": ann_id, "image_id": img_id, "category_id": cls,
                "bbox": [float(cx - bw / 2), float(cy - bh / 2), float(bw), float(bh)],
                "area": float(bw * bh), "iscrowd": 0,
            }
            if poly.size >= 6:
                pa = poly.copy()
                pa[:, 0] *= w
                pa[:, 1] *= h
                ann["segmentation"] = [pa.reshape(-1).tolist()]
            annotations.append(ann)
            ann_id += 1
    cats = [{"id": c, "name": (label_to_name or {}).get(c, str(c))}
            for c in sorted(classes)]
    Path(out_json).write_text(json.dumps(
        {"images": images, "annotations": annotations, "categories": cats}))
    return len(annotations)


def png_masks_to_yolo(masks_dir: Path, out_labels: Path, class_id: int = 0,
                      epsilon_frac: float = 0.005) -> int:
    """Binary PNG masks -> YOLO polygon labels via contours + Douglas-Peucker
    (reference png_mask_to_yolo.py:10-45)."""
    masks_dir, out_labels = Path(masks_dir), Path(out_labels)
    out_labels.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in sorted(masks_dir.iterdir()):
        if p.suffix.lower() != ".png":
            continue
        m = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        if m is None:
            continue
        h, w = m.shape
        cnts, _ = cv2.findContours((m > 127).astype(np.uint8), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        lines = []
        for c in cnts:
            eps = epsilon_frac * cv2.arcLength(c, True)
            c = cv2.approxPolyDP(c, eps, True).reshape(-1, 2).astype(np.float32)
            if len(c) < 3:
                continue
            c[:, 0] /= w
            c[:, 1] /= h
            lines.append(f"{class_id} " + " ".join(f"{v:.6f}" for v in c.reshape(-1)))
        if lines:
            (out_labels / f"{p.stem}.txt").write_text("\n".join(lines) + "\n")
            n += 1
    return n


def polys_to_bboxes(labels_dir: Path, out_dir: Path) -> int:
    """YOLO polygon labels -> YOLO bbox labels (reference polys2bbox.py:16-41)."""
    from ..data.yolo import parse_yolo_label_file

    labels_dir, out_dir = Path(labels_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in sorted(labels_dir.glob("*.txt")):
        boxes, _ = parse_yolo_label_file(p)
        lines = [f"{int(b[0])} {b[1]:.6f} {b[2]:.6f} {b[3]:.6f} {b[4]:.6f}"
                 for b in boxes]
        (out_dir / p.name).write_text("\n".join(lines) + ("\n" if lines else ""))
        n += 1
    return n


def csv_split_to_ultralytics(data_path: Path, out_path: Path,
                             label_to_name: Dict[int, str]) -> None:
    """CSV-split dataset -> Ultralytics YOLO directory layout + dataset.yaml
    (reference split_yolo_from_dfine.py)."""
    from ..data.loader import read_split_csv

    data_path, out_path = Path(data_path), Path(out_path)
    for split in ("train", "val", "test"):
        csv = data_path / f"{split}.csv"
        if not csv.exists():
            continue
        for sub in ("images", "labels"):
            (out_path / sub / split).mkdir(parents=True, exist_ok=True)
        for name in read_split_csv(csv):
            src_img = data_path / "images" / name
            src_lab = data_path / "labels" / f"{Path(name).stem}.txt"
            if src_img.exists():
                shutil.copy2(src_img, out_path / "images" / split / name)
            if src_lab.exists():
                shutil.copy2(src_lab, out_path / "labels" / split / src_lab.name)
    yaml_lines = [f"path: {out_path}", "train: images/train", "val: images/val",
                  "test: images/test", "names:"]
    yaml_lines += [f"  {k}: {v}" for k, v in sorted(label_to_name.items())]
    (out_path / "dataset.yaml").write_text("\n".join(yaml_lines) + "\n")


def ultralytics_to_csv_split(yolo_path: Path, out_path: Path) -> None:
    """Ultralytics layout -> flat images/labels + CSV splits
    (reference split_from_yolo.py:8-25)."""
    yolo_path, out_path = Path(yolo_path), Path(out_path)
    (out_path / "images").mkdir(parents=True, exist_ok=True)
    (out_path / "labels").mkdir(parents=True, exist_ok=True)
    for split in ("train", "val", "test"):
        img_dir = yolo_path / "images" / split
        if not img_dir.exists():
            continue
        names = []
        for p in sorted(img_dir.iterdir()):
            if p.suffix.lower() not in IMG_EXT:
                continue
            shutil.copy2(p, out_path / "images" / p.name)
            lab = yolo_path / "labels" / split / f"{p.stem}.txt"
            if lab.exists():
                shutil.copy2(lab, out_path / "labels" / lab.name)
            names.append(p.name)
        (out_path / f"{split}.csv").write_text("\n".join(names) + "\n")
