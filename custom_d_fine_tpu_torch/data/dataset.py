"""Dataset: YOLO-format images/labels -> static-shape padded samples.

Parity target: reference src/dl/dataset.py:76-468 (CustomDataset): modes
train/val/test/bench, BGR->RGB load, abs-xyxy targets, tiny-box filter,
polygon->mask rasterization for the segment task, mosaic branch, aug pipeline,
letterbox/resize, normalized-cxcywh outputs; ignore_background epochs.

The port's copy of custom_d_fine_tpu/data/dataset.py: every sample is padded
to `max_gt` with a validity mask, and the image stays uint8 HWC (normalised
on the card), so every batch of a canvas size has one shape.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np

from .augs import AugConfig, apply_train_augs
from .letterbox import letterbox_image, plain_resize
from .mosaic import MosaicConfig, build_mosaic
from .yolo import norm_poly_to_abs, norm_xywh_to_abs_xyxy, parse_yolo_label_file


def poly_to_mask(poly_abs: np.ndarray, h: int, w: int) -> np.ndarray:
    """Rasterize one absolute polygon to a binary mask (reference
    dl/utils.py:1016-1021 poly_abs_to_mask)."""
    mask = np.zeros((h, w), np.uint8)
    if poly_abs.size >= 6:
        cv2.fillPoly(mask, [np.round(poly_abs).astype(np.int32)], 1)
    return mask


class DFineDataset:
    def __init__(
        self,
        root_path: Path,
        names: Sequence[str],           # image file names (split CSV contents)
        img_size: Tuple[int, int],      # (h, w)
        mode: str,                      # train | val | test | bench
        max_gt: int = 100,
        task: str = "detect",
        keep_ratio: bool = False,
        use_one_class: bool = False,
        aug_cfg: Optional[AugConfig] = None,
        mosaic_cfg: Optional[MosaicConfig] = None,
        mask_downsample: int = 4,       # GT masks stored at img_size/mask_downsample
        seed: int = 42,
        min_box_px: float = 1.0,
        debug_img_path=None,   # save post-aug images with drawn GT (reference dataset.py:187-227)
        debug_img_limit: int = 100,
    ):
        assert mode in ("train", "val", "test", "bench"), mode
        self.root_path = Path(root_path)
        self.names = list(names)
        self.target_h, self.target_w = img_size
        self.mode = mode
        self.max_gt = max_gt
        self.task = task
        self.return_masks = task == "segment"
        self.keep_ratio = keep_ratio
        self.use_one_class = use_one_class
        self.aug_cfg = aug_cfg or AugConfig()
        self.mosaic_cfg = mosaic_cfg or MosaicConfig()
        self.mosaic_prob = self.mosaic_cfg.mosaic_prob if mode == "train" else 0.0
        self.mask_downsample = mask_downsample
        self.ignore_background = False
        self.min_box_px = min_box_px
        self.debug_img_path = debug_img_path
        self.debug_img_limit = debug_img_limit
        self._debug_saved = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.names)

    def close_mosaic(self) -> None:
        """Disable mosaic for the last no_mosaic_epochs (reference
        dataset.py:379-382)."""
        self.mosaic_prob = 0.0

    # ------------------------------------------------------------------ raw IO

    def load_raw(self, idx: int) -> Dict:
        """RGB image + [N,5] abs targets + abs polygons (reference
        dataset.py:229-256)."""
        name = self.names[idx]
        img_path = self.root_path / "images" / name
        image = cv2.imread(str(img_path))
        assert image is not None, f"Image wasn't loaded: {img_path}"
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        h, w = image.shape[:2]

        labels_path = self.root_path / "labels" / f"{Path(name).stem}.txt"
        targets = np.zeros((0, 5), np.float32)
        polys_abs: List[np.ndarray] = []
        if labels_path.exists() and labels_path.stat().st_size > 1:
            boxes_norm, polys_norm = parse_yolo_label_file(labels_path)
            if len(boxes_norm) and self.use_one_class:
                boxes_norm[:, 0] = 0
            if len(boxes_norm):
                xyxy = norm_xywh_to_abs_xyxy(boxes_norm[:, 1:5], h, w)
                targets = np.concatenate([boxes_norm[:, :1], xyxy], axis=1)
                polys_abs = [norm_poly_to_abs(p, h, w) for p in polys_norm]
        return {"image": image, "targets": targets, "segments": polys_abs,
                "orig_size": (h, w), "path": str(img_path)}

    # --------------------------------------------------------------- getitem

    def __getitem__(self, idx: int) -> Optional[Dict]:
        rng = self._rng
        raw = self.load_raw(idx)

        if self.mode == "train" and self.ignore_background and len(raw["targets"]) == 0:
            return None  # background skipped for first epochs (reference :400-401)

        use_mosaic = self.mode == "train" and rng.random() < self.mosaic_prob
        if use_mosaic:
            others = [self.load_raw(int(rng.integers(0, len(self)))) for _ in range(3)]
            image, targets, segments = build_mosaic(
                [raw] + others, (self.target_h, self.target_w), self.mosaic_cfg, rng
            )
        else:
            image, targets, segments = raw["image"], raw["targets"], raw["segments"]

        sample = {
            "image": image,
            "boxes": targets[:, 1:5].copy(),
            "labels": targets[:, 0].astype(np.int32),
        }
        masks = None
        if self.return_masks:
            h, w = image.shape[:2]
            segs = segments if segments else [np.empty((0, 2), np.float32)] * len(sample["boxes"])
            masks = np.stack([poly_to_mask(s, h, w) for s in segs]) if len(segs) else (
                np.zeros((0, h, w), np.uint8)
            )
            sample["masks"] = masks

        if self.mode == "train" and not use_mosaic:
            # the reference applies the photometric/geometric aug stack ONLY
            # on the non-mosaic path (dataset.py:420-447 self.transform);
            # mosaic samples get normalize alone (dataset.py:341
            # mosaic_transform = Compose(norm)) — found by the aug-ON
            # convergence A/B (PARITY_TRAINED.md aug-on section)
            sample = apply_train_augs(sample, self.aug_cfg, rng)

        # resize / letterbox (reference :110-131; scaleup only in train)
        image = sample["image"]
        if self.keep_ratio:
            canvas, p = letterbox_image(
                image, self.target_h, self.target_w, scaleup=(self.mode == "train")
            )
            boxes = sample["boxes"]
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [0, 2]] = boxes[:, [0, 2]] * p["ratio"] + p["pad_left"]
                boxes[:, [1, 3]] = boxes[:, [1, 3]] * p["ratio"] + p["pad_top"]
        else:
            canvas, p = plain_resize(image, self.target_h, self.target_w)
            boxes = sample["boxes"]
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [0, 2]] *= p["ratio_x"]
                boxes[:, [1, 3]] *= p["ratio_y"]

        masks_out = None
        if self.return_masks and sample.get("masks") is not None and len(sample["masks"]):
            mh = self.target_h // self.mask_downsample
            mw = self.target_w // self.mask_downsample
            ms = []
            for m in sample["masks"]:
                if self.keep_ratio:
                    from .letterbox import letterbox_mask

                    m2 = letterbox_mask(m, p)
                else:
                    m2 = (cv2.resize(m.astype(np.float32), (self.target_w, self.target_h),
                                     interpolation=cv2.INTER_LINEAR) > 0.5).astype(np.uint8)
                m2 = (cv2.resize(m2.astype(np.float32), (mw, mh),
                                 interpolation=cv2.INTER_LINEAR) > 0.5).astype(np.uint8)
                ms.append(m2)
            masks_out = np.stack(ms)

        # tiny-box filter (reference :404-409)
        labels = sample["labels"]
        if len(boxes):
            wh = boxes[:, 2:4] - boxes[:, 0:2]
            keep = (wh > self.min_box_px).all(axis=1)
            boxes, labels = boxes[keep], labels[keep]
            if masks_out is not None:
                masks_out = masks_out[keep]

        # normalized cxcywh, padded to max_gt (reference returns normalized
        # cxcywh at :461-465; padding is the static-shape addition)
        G = self.max_gt
        n = min(len(boxes), G)
        out_boxes = np.zeros((G, 4), np.float32)
        out_labels = np.zeros((G,), np.int32)
        valid = np.zeros((G,), bool)
        if n:
            b = boxes[:n]
            cxcywh = np.stack([
                (b[:, 0] + b[:, 2]) / 2 / self.target_w,
                (b[:, 1] + b[:, 3]) / 2 / self.target_h,
                (b[:, 2] - b[:, 0]) / self.target_w,
                (b[:, 3] - b[:, 1]) / self.target_h,
            ], axis=1)
            out_boxes[:n] = np.clip(cxcywh, 0.0, 1.0)
            out_labels[:n] = labels[:n]
            valid[:n] = True

        out = {
            "image": canvas,  # uint8 HWC RGB
            "boxes": out_boxes,
            "labels": out_labels,
            "valid": valid,
            "path": raw["path"],
            "orig_size": np.asarray(raw["orig_size"], np.int32),
            "letterbox": p,
        }
        if self.return_masks:
            mh = self.target_h // self.mask_downsample
            mw = self.target_w // self.mask_downsample
            mk = np.zeros((G, mh, mw), np.uint8)
            if masks_out is not None and len(masks_out):
                mk[:min(len(masks_out), G)] = masks_out[:G]
            out["masks"] = mk

        if self.debug_img_path and self._debug_saved < self.debug_img_limit:
            self._save_debug_image(idx, out, boxes[:n] if n else np.zeros((0, 4)))
        return out

    def _save_debug_image(self, idx, out, boxes_abs):
        """Post-augmentation render with drawn GT (reference dataset.py:187-227)."""
        from pathlib import Path as _P

        from ..utils.vis import vis_one_box

        img = cv2.cvtColor(out["image"].copy(), cv2.COLOR_RGB2BGR)
        for box, lab in zip(boxes_abs, out["labels"]):
            vis_one_box(img, box, int(lab), None, "gt")
        if "masks" in out:
            for m in out["masks"]:
                if m.any():
                    mm = cv2.resize(m.astype(np.uint8), (img.shape[1], img.shape[0]),
                                    interpolation=cv2.INTER_NEAREST)
                    cnts, _ = cv2.findContours(mm, cv2.RETR_EXTERNAL,
                                               cv2.CHAIN_APPROX_SIMPLE)
                    cv2.drawContours(img, cnts, -1, (0, 255, 0), 1)
        save_dir = _P(self.debug_img_path) / self.mode
        save_dir.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(save_dir / f"{idx}_debug.jpg"), img)
        self._debug_saved += 1
