"""The serving slice as a whole: custom_d_fine_tpu_torch's build_serving on
the CPU against the JAX package's make_serving_forward(use_fused_stem=False,
fast_topk=False), which on the CPU runs MSDA through XLA in f32, for every
registry size and a small 3-level model, on the same uint8 batch of 2.
The JAX side's raw pred_logits / pred_boxes are the ones its serving
forward hands to topk_detections (a wrapper passes them out beside the
detections), so the model is compiled once, inside the serving graph.

Weights: small3 and m take the JAX package's random init (build_model ->
jax.device_get -> flax_to_torch). n, s, l and x take the port's seeded
random init, converted into the flax tree by the JAX package's
convert_torch_state (jax.eval_shape gives the tree's structure without
compiling the init, which for x alone took ~90 s).

Tolerances: raw pred_logits / pred_boxes at rtol=atol=1e-4, query by query
in the order the query selection gives them; top-300 scores at atol 1e-4;
labels and boxes (pixels, so atol 1e-4 x image size) only where a score
stands more than 1e-4 from its neighbours, since near-ties may swap order
there.

The conv kernels of the random weights are scaled by sqrt(6)
(kaiming-uniform instead of torch's default bound) on both sides: at the
default scale the features of a random model fade through the ~40 conv
layers, its query-selection scores tie to within 1e-6, and the comparison
would test rounding instead of the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.configs import registry as jreg
from custom_d_fine_tpu.deploy.reparam import convert_to_deploy
from custom_d_fine_tpu.deploy import serving as jserving
from custom_d_fine_tpu.deploy.serving import make_serving_forward
from custom_d_fine_tpu.ops.postprocess import topk_detections as jtopk
from custom_d_fine_tpu.models.dfine import DFINE as JDFINE
from custom_d_fine_tpu.models.dfine import build_model
from custom_d_fine_tpu.utils.torch_convert import convert_torch_state
from custom_d_fine_tpu_torch.configs import registry as treg
from custom_d_fine_tpu_torch.deploy.serving import build_serving
from custom_d_fine_tpu_torch.models.dfine import build_model as tbuild
from custom_d_fine_tpu_torch.ops.stem import fold_stem_weights, stem_fwd
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch

from torch_threads import few_threads  # noqa: F401  (autouse)

IMG = (128, 128)  # the smallest size whose 336 anchors cover 300 queries
IMG_N = (256, 256)  # n's two levels (strides 16, 32) give 320 anchors here
TOL = 1e-4


def _small(reg):
    """3-level model: B0 backbone, hidden 64, points (3,6,3), 2 decoder layers,
    60 queries, built from either package's registry classes."""
    return reg.ModelConfig(
        name="small3",
        backbone=reg.BackboneConfig(name="B0", return_idx=(1, 2, 3), freeze_at=-1,
                                    freeze_norm=False, use_lab=True),
        encoder=reg.EncoderConfig(in_channels=(256, 512, 1024), feat_strides=(8, 16, 32),
                                  hidden_dim=64, use_encoder_idx=(2,), dim_feedforward=128,
                                  expansion=0.5, depth_mult=0.34),
        decoder=reg.DecoderConfig(feat_channels=(64, 64, 64), feat_strides=(8, 16, 32),
                                  hidden_dim=64, num_levels=3, num_layers=2, num_queries=60,
                                  num_points=(3, 6, 3), dim_feedforward=128,
                                  num_denoising=20),
        max_gt=10, dn_max_gt=10)


CONFIGS = {"small3": (_small(jreg), _small(treg)),
           **{size: (jreg.get_model_config(size), size) for size in ("n", "s", "m", "l", "x")}}


def _robust(scores):
    """Entries whose score is more than TOL from both neighbours (sorted)."""
    gap = np.full(scores.shape, np.inf)
    d = np.abs(np.diff(scores))
    gap[:-1] = np.minimum(gap[:-1], d)
    gap[1:] = np.minimum(gap[1:], d)
    return gap > TOL


JAX_INIT = ("small3", "m")  # the rest take the port's init


def _jax_init_weights(jcfg, img):
    """The JAX package's init; the flax variables and the port's state dict."""
    model, variables = build_model(jcfg, num_classes=80, img_size=img, train_batch=1)
    variables = jax.device_get(variables)
    variables["params"] = jax.tree_util.tree_map(
        lambda a: a * np.sqrt(6.0) if a.ndim == 4 else a, variables["params"])
    return model, variables, flax_to_torch(variables["params"], variables["batch_stats"])


def _port_init_weights(jcfg, tcfg, img):
    """The port's seeded init, converted into the flax tree."""
    tm = tbuild(tcfg, num_classes=80, seed=0)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(np.sqrt(6.0))
    sd = tm.state_dict()
    model = JDFINE(cfg=jcfg, num_classes=80)
    G = jcfg.max_gt
    dummy = {"labels": jnp.zeros((1, G), jnp.int32), "boxes": jnp.full((1, G, 4), 0.5),
             "valid": jnp.zeros((1, G), bool)}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1)},
        jnp.zeros((1, *img, 3)), targets=dummy, train=True))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats, _ = convert_torch_state({k: v.numpy() for k, v in sd.items()},
                                           zeros["params"], zeros["batch_stats"], strict=True)
    return model, {"params": params, "batch_stats": stats}, sd


@pytest.mark.parametrize("name", ["small3", "n", "s", "m", "l", "x"])
def test_serving_matches_jax(name):
    """Every registry size: n is the only 2-level path; l and x are B4/B5
    without LAB, with freeze_at=0 and a frozen backbone BatchNorm."""
    jcfg, tcfg = CONFIGS[name]
    tcfg = treg.get_model_config(tcfg) if isinstance(tcfg, str) else tcfg
    img = IMG_N if name == "n" else IMG
    x_u8 = np.random.default_rng(0).integers(0, 256, (2, *img, 3)).astype(np.uint8)

    if name in JAX_INIT:
        model, variables, sd = _jax_init_weights(jcfg, img)
    else:
        model, variables, sd = _port_init_weights(jcfg, tcfg, img)
    dmodel, dvars = convert_to_deploy(model, variables)

    def topk_and_raw(pred_logits, pred_boxes, *args, **kw):
        det = jtopk(pred_logits, pred_boxes, *args, **kw)
        return det, {"pred_logits": pred_logits, "pred_boxes": pred_boxes}

    with pytest.MonkeyPatch.context() as mp:  # traced with the wrapper
        mp.setattr(jserving, "topk_detections", topk_and_raw)
        fwd = make_serving_forward(dmodel, dvars, img, use_fused_stem=False, fast_topk=False)
        jdet, jraw = jax.device_get(jax.jit(fwd)(jnp.asarray(x_u8)))

    fn, tmodel = build_serving(tcfg, 80, img, device="cpu", state_dict=sd)
    xt = torch.from_numpy(x_u8)
    tdet = {k: v.numpy() for k, v in fn(xt).items()}
    with torch.inference_mode():
        stem = stem_fwd(xt, fold_stem_weights(tmodel.backbone.stem)).permute(0, 3, 1, 2)
        traw = tmodel(stem, stem_external=True)

    for k in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(traw[k].numpy(), jraw[k], rtol=TOL, atol=TOL, err_msg=k)
    assert tdet["scores"].shape == (2, 300)
    np.testing.assert_allclose(tdet["scores"], jdet["scores"], atol=TOL)
    for b in range(2):
        keep = _robust(jdet["scores"][b]) & _robust(tdet["scores"][b])
        assert keep.sum() >= 5  # random weights: most top-300 scores lie within 1e-4
        np.testing.assert_array_equal(tdet["labels"][b][keep], jdet["labels"][b][keep])
        np.testing.assert_allclose(tdet["boxes"][b][keep], jdet["boxes"][b][keep],
                                   atol=TOL * max(img))
