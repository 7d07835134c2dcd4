"""Export entry:
    python -m custom_d_fine_tpu_torch.cli.export [--config cfg] [--weights model.pt] [k=v ...]

Counterpart of custom_d_fine_tpu/cli/export.py; parity target reference
src/dl/export.py:278-338 (export main). Writes the serving graph as
torch.export artifacts into train.path_to_save: model_float32.pt2 and, when
export.half, model_bfloat16.pt2 (bfloat16 autocast inside the graph), each
for uint8 batches of export.max_batch_size, each loaded back and held
against the live forward (deploy/export.py:export_and_verify). An artifact
runs on the device and torch version it was made with; load it with
deploy/export.py:load_inference_artifact, which registers the port's kernels
first.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("--weights", default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from ..deploy.export import export_and_verify
    from ..infer.model import TorchModel
    from ..utils.config import load_config, resolve_experiment_dir
    from ..utils.logging import logger

    cfg = load_config(args.config, args.overrides)
    t = cfg["train"]
    t["path_to_save"] = resolve_experiment_dir(t["path_to_save"])
    num_classes = len(t["label_to_name"])
    img_size = tuple(t["img_size"])
    weights = args.weights or str(Path(t["path_to_save"]) / "model.pt")
    max_bs = cfg.get("export", {}).get("max_batch_size", 1)
    out_dir = Path(t["path_to_save"])
    if not Path(weights).exists():
        logger.warning(f"weights not found at {weights}; exporting random init")
        weights = None
    model = TorchModel(weights, cfg["model_name"], num_classes, img_size=img_size,
                       task=cfg.get("task", "detect"), smoke_test=False,
                       device=t.get("device")).model

    variants = ["float32"] + (["bfloat16"] if cfg.get("export", {}).get("half", False) else [])
    for name in variants:
        path = export_and_verify(model, img_size, out_dir / f"model_{name}.pt2",
                                 batch_size=max_bs, bf16=(name == "bfloat16"))
        logger.info(f"Exported + verified: {path}")


if __name__ == "__main__":
    main()
