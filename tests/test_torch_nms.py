"""The port's class-wise NMS (custom_d_fine_tpu_torch/ops/postprocess.py:
classwise_nms_padded) against the JAX package's
(custom_d_fine_tpu/ops/postprocess.py:91-128) on the same candidates: random
boxes with forced score ties, exact duplicate boxes (IoU 1), boxes that
touch or nest, and several classes. The keep masks must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.ops.postprocess import classwise_nms_padded as jax_nms
from custom_d_fine_tpu_torch.ops.postprocess import classwise_nms_padded


def _candidates(seed, n=300, n_cls=4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    labels = rng.integers(0, n_cls, n).astype(np.int32)
    # forced score ties (stable order decides), exact duplicate boxes of the
    # same and of another class, and degenerate (zero-area) boxes
    scores[10:20] = scores[5]
    scores[40:60:2] = 0.5
    boxes[100:110] = boxes[99]
    labels[100:105] = labels[99]
    boxes[120:125] = boxes[119]
    scores[120:125] = scores[119]
    boxes[200, 2:] = boxes[200, :2]
    boxes[201] = [50, 50, 60, 60]
    boxes[202] = [50, 50, 60, 60.001]
    labels[201] = labels[202]
    return boxes, scores, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", [0.3, 0.6, 0.9])
def test_nms_keep_mask_matches_jax(seed, thr):
    boxes, scores, labels = _candidates(seed)
    want = np.asarray(jax_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                              thr))
    got = classwise_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                               torch.from_numpy(labels), thr)
    assert got.dtype == torch.bool and got.shape == (300,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < 300  # something is suppressed, something kept


def test_nms_one_class_chain():
    """A chain where box 1 overlaps 0 and 2 but 0 and 2 do not overlap: with
    0 kept and 1 suppressed, 2 is kept (greedy, not transitive)."""
    boxes = np.array([[0, 0, 10, 10], [3, 0, 13, 10], [6, 0, 16, 10]], np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    labels = np.zeros(3, np.int32)
    want = np.asarray(jax_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                              0.3))
    got = classwise_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                               torch.from_numpy(labels), 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [True, False, True])
