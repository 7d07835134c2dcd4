"""Ultralytics YOLO wrapper adapting to the port's detection contract (a copy
of custom_d_fine_tpu/infer/yolo_model.py).

Parity target: reference src/infer/yolo_model.py:1-58 (thin ultralytics
wrapper used for external model comparisons in bench). ultralytics is an
optional dependency: where it is missing the wrapper raises a clear
ImportError at construction, and the bench/compare code paths stay
importable.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class YOLOModel:
    def __init__(self, model_path: str, conf_thresh: float = 0.5,
                 img_size=(640, 640)):
        try:
            from ultralytics import YOLO
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "ultralytics is not installed in this environment; YOLOModel "
                "is only available where the optional dependency exists"
            ) from e
        self.model = YOLO(model_path)
        self.conf_thresh = conf_thresh
        self.img_size = img_size

    def __call__(self, img_bgr: np.ndarray) -> List[Dict]:
        results = self.model(img_bgr, conf=self.conf_thresh, verbose=False)
        out = []
        for r in results:
            boxes = r.boxes.xyxy.cpu().numpy()
            labels = r.boxes.cls.cpu().numpy().astype(np.int32)
            scores = r.boxes.conf.cpu().numpy()
            det = {"labels": labels, "boxes": boxes, "scores": scores}
            if getattr(r, "masks", None) is not None:
                det["masks"] = r.masks.data.cpu().numpy().astype(np.uint8)
            out.append(det)
        return out
