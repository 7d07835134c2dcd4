"""Accuracy-controlled int8 quantization CLI (PyTorch; counterpart of
custom_d_fine_tpu/cli/quantize_int8.py).

Parity target: reference src/dl/ov_int8.py:18-163 (`make ov_int8`): quantize
the trained model with a validation-driven accuracy budget (max F1 drop),
validating with the full detection pipeline. Saves the int8 state dict and
the report with torch.save to <path_to_save>/model_int8.pt
({"model": state dict with <name>@q / <name>@scale entries, "report": ...}),
where the JAX package writes an orbax directory.

Usage: python -m custom_d_fine_tpu_torch.cli.quantize_int8 [--config cfg] [k=v ...]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--split", default="val")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    import torch

    from ..data.loader import Loader
    from ..deploy.quantize import (make_quantized_apply, quantizable_names,
                                   quantize_with_accuracy_control)
    from ..eval.validator import Validator
    from ..infer.model import TorchModel
    from ..ops.postprocess import topk_detections
    from ..utils.config import load_config, resolve_experiment_dir
    from ..utils.logging import logger

    cfg = load_config(args.config, args.overrides)
    t = cfg["train"]
    t["path_to_save"] = resolve_experiment_dir(t["path_to_save"])
    label_to_name = {int(k): v for k, v in t["label_to_name"].items()}
    weights = args.weights or str(Path(t["path_to_save"]) / "model.pt")
    max_drop = cfg.get("export", {}).get("ov_int8_max_drop", 0.02)

    runtime = TorchModel(
        weights, cfg["model_name"], len(label_to_name),
        img_size=tuple(t["img_size"]), task=cfg.get("task", "detect"),
        conf_thresh=t.get("conf_thresh", 0.5), keep_ratio=t.get("keep_ratio", False),
        smoke_test=False, device=t.get("device"),
    )
    model, device = runtime.model, runtime.device
    apply = make_quantized_apply(model)
    H, W = tuple(t["img_size"])

    loader = Loader(
        root_path=Path(t["data_path"]), img_size=(H, W),
        batch_size=t.get("batch_size", 8), num_workers=t.get("num_workers", 4),
        max_gt=t.get("max_gt", 100), keep_ratio=t.get("keep_ratio", False),
    )

    def validate(state) -> float:
        """Full F1 pipeline on the split (reference ov_int8 validation fn =
        Trainer.preds_postprocess + Validator)."""
        preds, gts = [], []
        for batch in loader.epoch_iterator(args.split, shuffle=False, drop_last=False):
            x = torch.from_numpy(batch["images"]).to(device)
            with torch.inference_mode():
                out = apply(state, x.permute(0, 3, 1, 2).float() / 255.0)
                dets = topk_detections(out["pred_logits"], out["pred_boxes"], 300, (H, W))
            dets = {k: v.cpu().numpy() for k, v in dets.items()}
            for b in range(batch["images"].shape[0]):
                keep = dets["scores"][b] >= t.get("conf_thresh", 0.5)
                preds.append({"boxes": dets["boxes"][b][keep],
                              "labels": dets["labels"][b][keep],
                              "scores": dets["scores"][b][keep]})
                v = batch["valid"][b]
                gb = batch["boxes"][b][v]
                xyxy = np.stack([
                    (gb[:, 0] - gb[:, 2] / 2) * W, (gb[:, 1] - gb[:, 3] / 2) * H,
                    (gb[:, 0] + gb[:, 2] / 2) * W, (gb[:, 1] + gb[:, 3] / 2) * H,
                ], 1) if len(gb) else np.zeros((0, 4), np.float32)
                gts.append({"boxes": xyxy, "labels": batch["labels"][b][v]})
        val = Validator(gts, preds, label_to_name,
                        conf_thresh=t.get("conf_thresh", 0.5),
                        iou_thresh=t.get("iou_thresh", 0.5), compute_maps=False)
        return val.compute_metrics()["f1"]

    qstate, report = quantize_with_accuracy_control(
        dict(model.state_dict()), quantizable_names(model), validate, max_drop=max_drop,
    )
    logger.info(f"int8 quantization report: "
                f"{json.dumps({k: v for k, v in report.items() if k != 'reverted'})}")

    out = Path(t["path_to_save"]) / "model_int8.pt"
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": {k: v.cpu() for k, v in qstate.items()}, "report": report}, out)
    logger.info(f"Saved int8 model to {out}")
    return report


if __name__ == "__main__":
    main()
