"""Eval-mode DFINETransformer of custom_d_fine_tpu_torch against the flax
decoder of custom_d_fine_tpu: same PAN features, same weights (carried by
flax_to_torch), logits and boxes at rtol=atol=1e-4 (f32 on both sides;
query selection, FDR loop and LQE compound the rounding of ~30 layers).

The flax weights are its generic init plus perturbed norms, not the
reference init, so the sampling offsets are random and the MSDA points land
on borders and outside the maps too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.models.decoder import DFINETransformer as FlaxDecoder
from custom_d_fine_tpu_torch.models.decoder import DFINETransformer, generate_anchors
from custom_d_fine_tpu.models.decoder import generate_anchors as flax_anchors
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch

TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb(v, rng):
    def walk(t, key=""):
        if hasattr(t, "items"):
            return {k: walk(val, k) for k, val in t.items()}
        a = np.asarray(t, np.float32)
        if key == "var":
            return a + rng.uniform(0.2, 0.8, a.shape).astype(np.float32)
        if key in ("scale", "mean"):
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if key == "bias":
            return a + rng.normal(0, 0.05, a.shape).astype(np.float32)
        return a
    return {k: walk(val) for k, val in v.items()}


@pytest.mark.parametrize("feat_channels,num_levels,sizes", [
    ((32, 32, 32), 3, ((16, 16), (8, 8), (4, 4))),   # 3 levels, no input projection
    ((48, 48), 3, ((16, 20), (8, 10))),              # projected + one extra strided level
])
def test_decoder_eval_matches_flax(feat_channels, num_levels, sizes):
    kw = dict(num_classes=7, hidden_dim=32, num_queries=40, feat_channels=feat_channels,
              num_levels=num_levels, num_points=(3, 6, 3)[:num_levels], nhead=4,
              num_layers=3, dim_feedforward=64, num_denoising=10)
    rng = np.random.default_rng(0)
    B = 2
    feats = [rng.normal(size=(B, h, w, c)).astype(np.float32)
             for (h, w), c in zip(sizes, feat_channels)]
    jf = [jnp.asarray(f) for f in feats]
    fm = FlaxDecoder(feat_strides=(8, 16, 32)[:len(feats)], dn_max_gt=5, **kw)
    targets = {"labels": jnp.zeros((B, 5), jnp.int32),
               "boxes": jnp.full((B, 5, 4), 0.5, jnp.float32),
               "valid": jnp.zeros((B, 5), bool).at[:, 0].set(True)}
    v = jax.jit(lambda f: fm.init({"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1)},
                                  f, targets=targets, train=True))(jf)
    v = _perturb(v, rng)
    want = jax.jit(lambda f: fm.apply(v, f, train=False))(jf)

    tm = DFINETransformer(feat_strides=(8, 16, 32)[:len(feats)], **kw).eval()
    tm.load_state_dict(flax_to_torch(v["params"], v["batch_stats"] if "batch_stats" in v
                                     else {}, "decoder"))
    with torch.no_grad():
        got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for k in ("pred_logits", "pred_boxes"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)


def test_generate_anchors_matches_flax():
    shapes = ((80, 80), (40, 40), (20, 20))
    a, v = generate_anchors(shapes)
    fa, fv = flax_anchors(shapes)
    np.testing.assert_array_equal(a, fa)
    np.testing.assert_array_equal(v, fv)
    assert np.isinf(a[~v[..., 0]]).all() and (~v).any()


def _box_cases():
    from custom_d_fine_tpu.ops import boxes as jb, fdr as jf, postprocess as jp
    from custom_d_fine_tpu_torch.ops import boxes as tb, fdr as tf, postprocess as tp

    rng = np.random.default_rng(7)
    b = rng.uniform(-0.2, 1.2, (5, 11, 4)).astype(np.float32)   # some negative widths
    d = rng.normal(size=(5, 11, 4)).astype(np.float32)
    logits = rng.normal(size=(2, 30, 7)).astype(np.float32)
    pred = rng.uniform(0, 1, (2, 30, 4)).astype(np.float32)
    xy = jb.box_cxcywh_to_xyxy(np.abs(b))
    x1, x2 = np.array(xy[0]), np.array(xy[1, :7])
    x1[0] = 0.0   # a padded (all-zero) box
    x2[1] = x2[0]  # a copy: IoU 1
    dist = rng.uniform(-12, 30, (3, 40)).astype(np.float32)  # below, inside, above the bins
    pts, gt = np.abs(b[2]), np.asarray(jb.box_cxcywh_to_xyxy(np.abs(b[3])))
    return {
        "box_iou_pairwise": (lambda: jb.box_iou_pairwise(x1, x2),
                             lambda: tb.box_iou_pairwise(torch.from_numpy(x1),
                                                         torch.from_numpy(x2))),
        "elementwise_box_iou": (lambda: jb.elementwise_box_iou(x1, x2[:1].repeat(11, 0)),
                                lambda: tb.elementwise_box_iou(
                                    torch.from_numpy(x1), torch.from_numpy(x2[:1].repeat(11, 0)))),
        "generalized_box_iou_pairwise": (
            lambda: jb.generalized_box_iou_pairwise(x1, x2),
            lambda: tb.generalized_box_iou_pairwise(torch.from_numpy(x1), torch.from_numpy(x2))),
        "elementwise_generalized_box_iou": (
            lambda: jb.elementwise_generalized_box_iou(x1, x2[:1].repeat(11, 0)),
            lambda: tb.elementwise_generalized_box_iou(torch.from_numpy(x1),
                                                       torch.from_numpy(x2[:1].repeat(11, 0)))),
        "translate_gt": (lambda: jf.translate_gt(jnp.asarray(dist), 32, 4.0, 0.5),
                         lambda: tf.translate_gt(torch.from_numpy(dist), 32, 4.0, 0.5)),
        "bbox2distance": (lambda: jf.bbox2distance(jnp.asarray(pts), jnp.asarray(gt), 32, 4.0, 0.5),
                          lambda: tf.bbox2distance(torch.from_numpy(pts), torch.from_numpy(gt),
                                                   32, 4.0, 0.5)),
        "cxcywh_to_xyxy": (lambda: jb.box_cxcywh_to_xyxy(b),
                           lambda: tb.box_cxcywh_to_xyxy(torch.from_numpy(b))),
        "xyxy_to_cxcywh": (lambda: jb.box_xyxy_to_cxcywh(b),
                           lambda: tb.box_xyxy_to_cxcywh(torch.from_numpy(b))),
        "inverse_sigmoid": (lambda: jb.inverse_sigmoid(b),
                            lambda: tb.inverse_sigmoid(torch.from_numpy(b))),
        "weighting_function": (lambda: jf.weighting_function(32, jnp.float32(0.5),
                                                             jnp.float32(4.0)),
                               lambda: tf.weighting_function(32, 0.5, 4.0)),
        "distance2bbox": (lambda: jf.distance2bbox(np.abs(b), d, 4.0),
                          lambda: tf.distance2bbox(torch.from_numpy(np.abs(b)),
                                                   torch.from_numpy(d), 4.0)),
        "topk_detections": (
            lambda: jp.topk_detections(jnp.asarray(logits), jnp.asarray(pred), 25, (64, 96)),
            lambda: tp.topk_detections(torch.from_numpy(logits), torch.from_numpy(pred), 25,
                                       (64, 96))),
    }


@pytest.mark.parametrize("name", ["cxcywh_to_xyxy", "xyxy_to_cxcywh", "inverse_sigmoid",
                                  "weighting_function", "distance2bbox", "topk_detections",
                                  "box_iou_pairwise", "elementwise_box_iou",
                                  "generalized_box_iou_pairwise",
                                  "elementwise_generalized_box_iou", "translate_gt",
                                  "bbox2distance"])
def test_box_fdr_and_postprocess_match_jax(name):
    """ops/boxes.py, ops/fdr.py and ops/postprocess.py against the JAX
    functions on the same inputs, at rtol=atol=1e-5 (f32 elementwise; the
    top-K scores of random normal logits have no ties). The IoU cases hold a
    padded all-zero box and boxes with negative widths; the FDR targets
    distances below, inside and above the bins."""
    want, got = (f() for f in _box_cases()[name])
    if isinstance(got, dict):
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    elif isinstance(got, tuple):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=str(i))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
