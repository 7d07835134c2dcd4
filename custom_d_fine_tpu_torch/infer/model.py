"""Deployment inference runtime: __call__(BGR image) -> detections (PyTorch),
counterpart of custom_d_fine_tpu/infer/model.py:JaxModel.

Parity target: reference src/infer/torch_model.py (Torch_model): letterbox /
resize preprocess (:240-264), device forward (:266-302), postprocess with
per-class conf thresholds, optional class-wise NMS (:526-597), mask2poly
contour extraction (:342-375), and the constructor smoke test (_test_pred
:81-85).

The forward is deploy/serving.py's graph (the stem and MSDA kernels on the
card) in float32, bfloat16 (autocast) or int8 (per-channel int8 weights
dequantized in the graph). Weights are a torch checkpoint: an original
`.pth` or the port Trainer's `model.pt`/`last.pt` (EMA weights first).
The JAX package's orbax branch has no counterpart, and msda_impl (its choice
of TPU kernel) none either: the port has one MSDA kernel.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import cv2
import numpy as np
import torch

from ..configs.registry import get_model_config
from ..data.letterbox import letterbox_image, plain_resize, unletterbox_boxes_abs
from ..deploy.reparam import convert_to_deploy
from ..deploy.serving import make_serving_forward, resolve_device
from ..models.dfine import build_model
from ..ops.postprocess import classwise_nms_padded
from ..utils.checkpoint import load_matched, load_torch_checkpoint_file, remap_obj365_head
from ..utils.logging import logger

DTYPES = ("float32", "bfloat16", "int8")


def mask_to_polygons(mask: np.ndarray) -> List[np.ndarray]:
    """Binary mask -> external contours (reference torch_model.py:342-375)."""
    cnts, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL,
                               cv2.CHAIN_APPROX_SIMPLE)
    return [c.reshape(-1, 2).astype(np.float32) for c in cnts if len(c) >= 3]


def masks_to_frame(masks: np.ndarray, boxes: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Mask probabilities at H/4 of the canvas [n, Hm, Wm] and their boxes
    (xyxy pixels of the original frame) -> uint8 {0,1} masks (n, oh, ow):
    each resized straight to the frame (cv2.INTER_LINEAR; with keep_ratio the
    letterbox padding is not cut off first, as in the JAX runtime and
    Trainer), binarised at 0.5 and zeroed outside its box (JAX
    infer/model.py:172-190 and train/trainer.py:586-605; reference
    torch_model.py:104-151, 208-223). The runtime and the Trainer's eval
    both use it."""
    full = []
    for m, b in zip(masks, boxes):
        mm = (cv2.resize(m.astype(np.float32), (ow, oh), interpolation=cv2.INTER_LINEAR)
              > 0.5).astype(np.uint8)
        crop = np.zeros_like(mm)
        x1, y1, x2, y2 = (int(v) for v in b)
        crop[max(y1, 0):y2, max(x1, 0):x2] = mm[max(y1, 0):y2, max(x1, 0):x2]
        full.append(crop)
    return np.stack(full) if full else np.zeros((0, oh, ow), np.uint8)


class TorchModel:
    """BGR HWC uint8 image(s) -> list of {"labels", "boxes" (xyxy pixels of
    the original image), "scores"} dicts, thresholded (and NMS-filtered when
    enable_nms); with task="segment" also "masks", uint8 (n, h, w) in the
    original frame. Runs on the card unless device="cpu"."""

    def __init__(
        self,
        model_path: Optional[str],
        model_name: str,
        num_classes: int,
        img_size: Tuple[int, int] = (640, 640),
        task: str = "detect",
        conf_thresh: Union[float, Dict[int, float]] = 0.5,
        keep_ratio: bool = False,
        enable_nms: bool = False,
        nms_iou_thresh: float = 0.6,
        dtype: str = "float32",    # float32 | bfloat16 (autocast) | int8 (weights)
        deploy: bool = True,       # reparam-fuse VGGBlocks (deploy/reparam.py)
        smoke_test: bool = True,
        device: Union[None, str, torch.device] = None,
    ):
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
        self.device = resolve_device(device)
        self.img_size = tuple(img_size)
        self.task = task
        self.keep_ratio = keep_ratio
        self.enable_nms = enable_nms
        self.nms_iou_thresh = nms_iou_thresh
        self.num_classes = num_classes
        if isinstance(conf_thresh, dict):
            self.conf = np.full((num_classes,), 0.5, np.float32)
            for k, v in conf_thresh.items():
                self.conf[int(k)] = v
        else:
            self.conf = np.full((num_classes,), float(conf_thresh), np.float32)

        cfg = get_model_config(model_name, enable_mask_head=(task == "segment"))
        self.model = build_model(cfg, num_classes=num_classes)
        if model_path:
            self._load_weights(model_path, num_classes)
        if deploy:
            # merge VGGBlock branches into single convs (reference deploy()
            # reparam, dfine.py:30-41)
            convert_to_deploy(self.model)
        self.model.to(self.device)
        # the serving forward: uint8 [B,H,W,3] on self.device -> detection tensors
        self.infer = make_serving_forward(self.model, self.img_size,
                                          quantize_int8=(dtype == "int8"),
                                          bf16=(dtype == "bfloat16"))
        self.timings: Dict[str, float] = {}  # the last call's preprocess/forward/postprocess ms
        if smoke_test:
            self._test_pred()

    # ----------------------------------------------------------- weights

    def _load_weights(self, path: str, num_classes: int) -> None:
        path = Path(path)
        if path.suffix not in (".pth", ".pt"):
            raise ValueError(f"{path}: expected a torch checkpoint (.pth or .pt)")
        state = remap_obj365_head(load_torch_checkpoint_file(str(path)), num_classes)
        report = load_matched(self.model, state)
        logger.info(f"Loaded torch ckpt {path}: {len(report['missed'])} missed, "
                    f"{len(report['unmatched'])} unmatched, "
                    f"{len(report['shape_mismatch'])} of another shape")

    # ----------------------------------------------------------- pipeline

    def _prepare(self, img_bgr: np.ndarray):
        rgb = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)
        h, w = rgb.shape[:2]
        if self.keep_ratio:
            canvas, p = letterbox_image(rgb, self.img_size[0], self.img_size[1], scaleup=True)
        else:
            canvas, p = plain_resize(rgb, self.img_size[0], self.img_size[1])
        return canvas, p, (h, w)

    def _postprocess_one(self, dets: Dict[str, np.ndarray], p: Dict, orig_hw) -> Dict:
        oh, ow = orig_hw
        boxes, scores, labels = dets["boxes"], dets["scores"], dets["labels"]
        if p.get("ratio") is not None:
            boxes = unletterbox_boxes_abs(boxes, p, oh, ow)
        else:
            boxes = boxes.copy()
            boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]] / p["ratio_x"], 0, ow)
            boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]] / p["ratio_y"], 0, oh)

        keep = scores >= self.conf[np.clip(labels, 0, self.num_classes - 1)]
        if self.enable_nms:
            # NMS over the static top-K set, in the original frame, as the
            # JAX runtime runs it
            keep = keep & classwise_nms_padded(
                torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(labels),
                self.nms_iou_thresh).numpy()
        out = {"labels": labels[keep], "boxes": boxes[keep], "scores": scores[keep]}
        if self.task == "segment":
            out["masks"] = masks_to_frame(dets["masks"][keep], out["boxes"], oh, ow)
        return out

    def __call__(self, images_bgr: Union[np.ndarray, Sequence[np.ndarray]]) -> List[Dict]:
        """BGR HWC image (or list) -> list of detection dicts (reference
        torch_model.py:327-340). `self.timings` holds the call's host ms of
        preprocess, forward (ending with the detections on the host) and
        postprocess."""
        t0 = time.perf_counter()
        single = isinstance(images_bgr, np.ndarray) and images_bgr.ndim == 3
        imgs = [images_bgr] if single else list(images_bgr)
        prepared = [self._prepare(im) for im in imgs]
        batch = torch.from_numpy(np.stack([c for c, _, _ in prepared])).to(self.device)
        t1 = time.perf_counter()
        dets = {k: v.cpu().numpy() for k, v in self.infer(batch).items()}
        t2 = time.perf_counter()
        results = [self._postprocess_one({k: v[i] for k, v in dets.items()}, p, hw)
                   for i, (_, p, hw) in enumerate(prepared)]
        t3 = time.perf_counter()
        self.timings = {"preprocess_ms": (t1 - t0) * 1e3, "forward_ms": (t2 - t1) * 1e3,
                        "postprocess_ms": (t3 - t2) * 1e3}
        return results

    def _test_pred(self):
        """Startup smoke predict (reference torch_model.py:81-85)."""
        dummy = np.zeros((320, 400, 3), np.uint8)
        out = self(dummy)
        assert isinstance(out, list) and "boxes" in out[0]
        logger.info("TorchModel smoke test OK")
