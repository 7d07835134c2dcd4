"""The port's evaluation (custom_d_fine_tpu_torch/eval/*) against the JAX
package's (custom_d_fine_tpu/eval/*), on the cases of tests/test_validator.py
and the randomised sets of tests/test_coco_map_native.py: the same inputs
must give the same dicts, exactly (both are the same numpy and C++ code).

  - Validator(...).compute_metrics(extended=True), with mAP on, for every
    box and mask case of test_validator.py (masks also as RLE); the
    resolution-mismatch case without mAP, as there (its mask mAP needs masks
    of one size, in both packages);
  - coco_map on its COCOeval cases (crowds, area ranges, maxDets, the
    non-ignored-first rule) in every area bucket;
  - coco_map with the port's native matcher (its own copy of
    native/cocomatch.cpp, built into the port's build directory) against
    the JAX package's numpy matcher, boxes and masks, with score ties.
"""

import numpy as np
import pytest

from custom_d_fine_tpu.eval.coco_map import coco_map as jcoco_map
from custom_d_fine_tpu.eval.validator import Validator as JValidator
from custom_d_fine_tpu_torch.eval import cocomatch_native
from custom_d_fine_tpu_torch.eval.coco_map import coco_map
from custom_d_fine_tpu_torch.eval.rle import masks_to_rle
from custom_d_fine_tpu_torch.eval.validator import Validator

from test_coco_map_native import _rand_dataset
from test_validator import M_FULL, M_PARTIAL, M_SMALL, _img, pack


def _case6():
    gt6 = np.zeros((7, 8), np.uint8)
    gt6[1:6, 1:7] = 1
    p1 = np.zeros((7, 8), np.uint8)
    p1[1:3, 1:6] = 1
    p1[3, 1:4] = 1
    p1[4, 1:3] = 1
    p1[5, 1:3] = 1
    p1[5, 6] = 1
    p1[6, 5:7] = 1
    p2 = np.zeros((7, 8), np.uint8)
    p2[4:7, 5:7] = 1
    return [pack([gt6], [0])], [pack([p1, p2], [0, 0], [1.0, 1.0])]


def _rle(sample):
    out = {k: v for k, v in sample.items() if k != "masks"}
    out["masks_rle"] = masks_to_rle(sample["masks"])
    return out


VALIDATOR_CASES = {
    "perfect": ([pack([M_SMALL], [0])], [pack([M_SMALL], [0], [1.0])]),
    "partial": ([pack([M_FULL], [0])], [pack([M_PARTIAL], [0], [1.0])]),
    "misclassified": ([pack([M_SMALL], [0])], [pack([M_SMALL], [1], [1.0])]),
    "pure_fp": ([pack([], [])], [pack([M_SMALL], [0], [1.0])]),
    "resolution": ([pack([np.ones((10, 10), np.uint8)], [2])],
                   [pack([np.ones((5, 5), np.uint8)], [2], [1.0])]),
    "one_gt_many_preds": _case6(),
    "rle": ([_rle(pack([M_SMALL], [0]))], [_rle(pack([M_SMALL], [0], [1.0]))]),
    "boxes_only": ([{k: v for k, v in pack([M_SMALL, M_FULL], [0, 1]).items() if k != "masks"}],
                   [{k: v for k, v in pack([M_SMALL, M_PARTIAL], [0, 1], [0.9, 0.4]).items()
                     if k != "masks"}]),
}


@pytest.mark.parametrize("name", list(VALIDATOR_CASES))
def test_validator_matches_jax(name):
    gt, preds = VALIDATOR_CASES[name]
    labels = {int(l): f"class_{l}" for s in gt + preds for l in np.asarray(s["labels"])}
    kw = dict(conf_thresh=0.5, iou_thresh=0.5, compute_maps=name != "resolution")
    got, want = Validator(gt, preds, labels, **kw), JValidator(gt, preds, labels, **kw)
    assert got.compute_metrics(extended=True) == want.compute_metrics(extended=True)
    np.testing.assert_array_equal(got.conf_matrix, want.conf_matrix)
    assert got.class_to_idx == want.class_to_idx


COCO_CASES = {
    "crowd": ([_img([[0, 0, 50, 50], [100, 100, 150, 150]], [0, 0], iscrowd=[False, True])],
              [_img([[100, 100, 150, 150], [102, 102, 150, 150], [0, 0, 50, 50]], [0, 0, 0],
                    scores=[0.9, 0.8, 0.7])]),
    "area_ranges": ([_img([[0, 0, 20, 20], [100, 100, 300, 300]], [0, 0])],
                    [_img([[0, 0, 20, 20], [100, 100, 300, 300], [400, 400, 415, 415]],
                          [0, 0, 0], scores=[0.9, 0.8, 0.95])]),
    "max_dets": ([_img([[0, 0, 50, 50], [100, 0, 150, 50]], [0, 0])],
                 [_img([[200, 200, 250, 250], [300, 300, 350, 350], [0, 0, 50, 50],
                        [100, 0, 150, 50]], [0, 0, 0, 0], scores=[0.95, 0.9, 0.8, 0.7])]),
    "non_ignored_first": ([_img([[0, 0, 100, 100], [0, 0, 130, 130]], [0, 0],
                                iscrowd=[False, True])],
                          [_img([[0, 0, 120, 120]], [0], scores=[0.9])]),
}


@pytest.mark.parametrize("name", list(COCO_CASES))
@pytest.mark.parametrize("max_dets", [2, 100])
def test_coco_map_matches_jax(name, max_dets):
    gt, preds = COCO_CASES[name]
    assert coco_map(preds, gt, max_dets=max_dets) == jcoco_map(preds, gt, max_dets=max_dets)


@pytest.mark.parametrize("seed,iou_type", [(0, "bbox"), (1, "bbox"), (7, "segm")])
def test_native_cocomatch_matches_jax_numpy(seed, iou_type):
    """The port's native matcher against the JAX package's numpy oracle;
    odd seeds quantise scores and boxes into ties."""
    assert cocomatch_native.available(), "the port's cocomatch did not build"
    rng = np.random.default_rng(seed)
    preds, gts = _rand_dataset(rng, n_img=10, n_cls=4, masks=iou_type == "segm",
                               quantize=8 if seed % 2 else None)
    want = jcoco_map(preds, gts, iou_type=iou_type, native=False)
    assert coco_map(preds, gts, iou_type=iou_type, native=True) == want
    assert coco_map(preds, gts, iou_type=iou_type, native=False) == want
