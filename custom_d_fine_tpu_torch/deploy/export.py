"""Export: the serving graph (model + postprocessor) as a torch.export
artifact, counterpart of custom_d_fine_tpu/deploy/export.py.

Parity target: reference src/dl/export.py:131-275 (ONNX/OpenVINO/TensorRT
exporters). The artifact is `torch.export.export` of deploy/serving.py's
ServingModule, saved with `torch.export.save` to a .pt2 file; the weights
ride inside, as the JAX package's closed-over constants do. The stem and
MSDA kernels are custom ops (`dfine_port::stem_fwd`, `dfine_port::msda_fwd`),
so the loaded artifact launches them: import the port's ops before
`torch.export.load` (load_inference_artifact does), or the ops are unknown.
An artifact is tied to the torch version and the device it was made on. The
bfloat16-compute variant keeps its autocast region inside the graph.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from .serving import make_serving_forward


def export_inference_artifact(model, img_size: Tuple[int, int], out_path: Path,
                              batch_size: int = 1, num_top: int = 300,
                              bf16: bool = False) -> Path:
    """torch.export the serving graph of a deploy model (on its device) for
    uint8 [batch_size, H, W, 3] inputs and save it to `out_path` (.pt2)."""
    module = make_serving_forward(model, img_size, num_top=num_top, bf16=bf16).module
    H, W = img_size
    example = torch.zeros((batch_size, H, W, 3), dtype=torch.uint8,
                          device=next(model.parameters()).device)
    with torch.no_grad():
        exported = torch.export.export(module, (example,))
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, str(out_path))
    return out_path


def load_inference_artifact(path: Path) -> torch.nn.Module:
    """The saved artifact as a callable module (uint8 batch -> detections)."""
    from ..ops import msda, stem  # noqa: F401  (registers the custom ops)

    return torch.export.load(str(path)).module()


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes [N,4] x [M,4] -> [N,M]."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), -1)
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), -1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def check_same_detections(a, b, top_check: int = 50) -> float:
    """The set-based check of export_and_verify: `a` against the reference
    detections `b` (dicts of numpy [B, K] arrays). Sorted score curves within
    atol 2e-2, and each of b's top `top_check` detections must have a
    same-label, IoU >= 0.5 counterpart in `a` within 0.02 in score, for all
    but 5% of them. Raises AssertionError; returns the unmatched share."""
    sa, sb = np.asarray(a["scores"]), np.asarray(b["scores"])
    ba, bb = np.asarray(a["boxes"]), np.asarray(b["boxes"])
    la, lb = np.asarray(a["labels"]), np.asarray(b["labels"])
    np.testing.assert_allclose(np.sort(sa, -1), np.sort(sb, -1), atol=2e-2,
                               err_msg="score curves diverge")
    n_bad, total = 0, 0
    for i in range(sa.shape[0]):
        k = min(top_check, sb.shape[1])
        order = np.argsort(-sb[i], kind="stable")[:k]  # the reference's top detections
        iou = _iou_matrix(bb[i][order], ba[i])  # against all of a's detections
        same = lb[i][order][:, None] == la[i][None, :]
        close = np.abs(sb[i][order][:, None] - sa[i][None, :]) < 2e-2
        n_bad += int((~((iou >= 0.5) & same & close).any(1)).sum())
        total += k
    frac = n_bad / max(total, 1)
    assert frac <= 0.05, (f"detections diverge: {n_bad}/{total} top detections have no "
                          f"same-label IoU>=0.5 counterpart within score tol")
    return frac


def export_and_verify(model, img_size: Tuple[int, int], out_path: Path, batch_size: int = 1,
                      top_check: int = 50, bf16: bool = False) -> Path:
    """Export, load the artifact back and hold it against the live serving
    forward on a random uint8 batch (stands in for the reference's
    cross-backend F1 consistency test, bench.py:236-267). On the CPU every
    output at rtol = atol = 1e-5 (a segment model's masks too). On the card,
    as the JAX package's check on the TPU, set-based (check_same_detections,
    on the boxes, labels and scores): near-tied entries may swap places in
    the sorted top-K between two runs of the graph. Both sides must return
    the same outputs (a segment artifact carries "masks")."""
    path = export_inference_artifact(model, img_size, out_path, batch_size, bf16=bf16)
    fn = load_inference_artifact(path)
    device = next(model.parameters()).device
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 255, (batch_size, *img_size, 3)).astype(np.uint8))
    img = img.to(device)
    live = make_serving_forward(model, img_size, bf16=bf16)
    with torch.inference_mode():
        a = {k: v.cpu().numpy() for k, v in fn(img).items()}
        b = {k: v.cpu().numpy() for k, v in live(img).items()}
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    if device.type == "cpu":
        for k in a:  # boxes, scores, labels, and a segment model's masks
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5, err_msg=k)
    else:
        check_same_detections(a, b, top_check)
    return path
