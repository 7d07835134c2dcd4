"""The decoder's other options in the port against the JAX package:
query_select_method "agnostic" (a 1-column encoder score head, the
criterion's encoder sets scored as one class) and "one2many" (top-K over
(anchor, class) pairs), and cross_attn_method "discrete" (nearest-pixel
sampling).

- ms_deform_attn_discrete against the JAX package's ms_deform_attn_xla
  (method="discrete") on identical inputs: the output at 1e-6, the
  gradients of value and attention against jax.grad at 1e-5, and none to
  the locations on either side. The inputs put loc*W at k + 0.4, k + 0.5
  and k + 0.6 (W a power of two, so k + 0.5 is exact) and locations below
  0 and above 1.
- The eval-mode DFINETransformer for each option against the flax decoder
  (msda_impl="xla", the path that honours "discrete"), in the pattern of
  tests/test_torch_decoder.py: logits and boxes query by query, in encoder
  order, at rtol = atol = 1e-4. Under one2many an anchor chosen for two
  classes gives two equal queries, so the final scores tie; the encoder
  order has no ties (distinct random logits). Under discrete both sides'
  sampling indices are recorded per layer (JAX's locations at its
  ms_deform_attn call, the port's by a forward hook), and a coordinate that
  rounds to another pixel on one side is named.
- Train mode under agnostic: enc_meta, the 1-column encoder set against
  JAX's, and every loss term of the criterion (the `_enc_0` terms scored
  with zeroed labels and one class) on the same outputs at the criterion
  tolerances of tests/test_torch_criterion.py (rtol 1e-5, atol 1e-7); the
  matcher's cost of a 1-column set against JAX's.
- The weights: flax_to_torch of an agnostic model's tree is the identity
  on the port's key set and shapes; load_matched of a default checkpoint
  reports the 1-row head as a shape mismatch, as JAX's convert_torch_state
  does; remap_obj365_head leaves a 1-row head as it is, as JAX's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.configs import get_model_config as jax_config
from custom_d_fine_tpu.models import decoder as jdec
from custom_d_fine_tpu.models.decoder import DFINETransformer as FlaxDecoder
from custom_d_fine_tpu.models.dfine import DFINE as JaxDFINE
from custom_d_fine_tpu.ops.deform_attn import ms_deform_attn_xla
from custom_d_fine_tpu.train import matcher as jmatcher
from custom_d_fine_tpu.train.criterion import DFINECriterion as JCriterion
from custom_d_fine_tpu.utils import torch_convert as jconvert
from custom_d_fine_tpu_torch.configs import get_model_config
from custom_d_fine_tpu_torch.models import decoder as tdec
from custom_d_fine_tpu_torch.models.decoder import DFINETransformer
from custom_d_fine_tpu_torch.models.dfine import DFINE
from custom_d_fine_tpu_torch.ops.deform_attn import discrete_index, ms_deform_attn_discrete
from custom_d_fine_tpu_torch.train import matcher as tmatcher
from custom_d_fine_tpu_torch.train.criterion import DFINECriterion
from custom_d_fine_tpu_torch.utils.checkpoint import load_matched, remap_obj365_head
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch

from helpers import tiny_config
from test_torch_decoder import _perturb
from test_torch_train_step import port_config
from torch_threads import few_threads  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
NC, B, Q = 7, 2, 40
SIZES = ((16, 16), (8, 8), (4, 4))  # MSDA levels: powers of two, so k + 0.5 is exact
KW = dict(num_classes=NC, hidden_dim=32, num_queries=Q, feat_channels=(32, 32, 32),
          feat_strides=(8, 16, 32), num_levels=3, num_points=(3, 6, 3), nhead=4,
          num_layers=3, dim_feedforward=64, num_denoising=10)


# ---------------------------------------------------------------- sampling
def _sampling_inputs():
    """value [2, 6*8 + 3*4, 2, 4], loc [2, 7, 2, 5, 2], attn [2, 7, 2, 5] on
    levels (6, 8) and (3, 4) with (3, 2) points. Query 0 puts x*W and y*H at
    k + 0.4, k + 0.5 and k + 0.6 on level 0 and at 1.5 on level 1; query 1
    puts its points below 0 and above 1 (and x*W + 0.5 in (-1, 0), where a
    truncating and a flooring cast differ before the clamp)."""
    rng = np.random.default_rng(0)
    shapes, points = ((6, 8), (3, 4)), (3, 2)
    value = rng.normal(size=(2, 60, 2, 4)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (2, 7, 2, 5, 2)).astype(np.float32)
    for p, frac in enumerate((0.4, 0.5, 0.6)):
        loc[:, 0, :, p] = [(3 + frac) / 8, (2 + frac) / 6]
    loc[:, 0, :, 3] = [1.5 / 4, 1.5 / 3]
    loc[:, 0, :, 4] = [0.5 / 4, 2.5 / 3]
    loc[:, 1, :, :, 0] = [-0.2, -0.9 / 8, 1.2, -0.05, 1.01]
    loc[:, 1, :, :, 1] = [1.3, 0.99, -0.4, 1.2, -0.01]
    logits = rng.normal(size=(2, 7, 2, 5)).astype(np.float32)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return shapes, points, value, loc, attn.astype(np.float32)


def test_discrete_sampling_matches_jax():
    shapes, points, value, loc, attn = _sampling_inputs()
    # the index rule on the chosen points: k + 0.4 -> k, k + 0.5 and k + 0.6 -> k + 1
    idx = discrete_index(torch.from_numpy(loc[0, 0, 0, :3]), 6, 8)
    assert idx.tolist() == [2 * 8 + 3, 3 * 8 + 4, 3 * 8 + 4]
    assert discrete_index(torch.from_numpy(loc[0, 1, 0, :3]), 6, 8).tolist() == [
        5 * 8 + 0, 5 * 8 + 0, 0 * 8 + 7]

    g = np.random.default_rng(1).normal(size=(2, 7, 8)).astype(np.float32)

    def jax_loss(v, l, a):
        out = ms_deform_attn_xla(v, shapes, l, a, list(points), method="discrete")
        return (out * g).sum(), out

    (_, want), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    tv, tl, ta = (torch.from_numpy(a).requires_grad_() for a in (value, loc, attn))
    got = ms_deform_attn_discrete(tv, shapes, tl, ta, points)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    gv, gl, ga = torch.autograd.grad((got * torch.from_numpy(g)).sum(), (tv, tl, ta),
                                     allow_unused=True)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgrads[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ga.numpy(), np.asarray(jgrads[2]), rtol=0, atol=1e-5)
    assert not np.asarray(jgrads[1]).any()  # JAX's int cast cuts the gradient
    assert gl is None or not gl.any()


# ---------------------------------------------------------------- the decoder
def _decoder_pair(option, train=False):
    """(flax decoder, its perturbed variables, the port's decoder with the
    same weights, NHWC features) for one option."""
    opt = ({"cross_attn_method": option} if option == "discrete"
           else {"query_select_method": option})
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(B, h, w, 32)).astype(np.float32) for h, w in SIZES]
    fm = FlaxDecoder(dn_max_gt=5, msda_impl="xla", **KW, **opt)
    targets = {"labels": jnp.zeros((B, 5), jnp.int32),
               "boxes": jnp.full((B, 5, 4), 0.5, jnp.float32),
               "valid": jnp.zeros((B, 5), bool).at[:, 0].set(True)}
    v = jax.jit(lambda f: fm.init({"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1)},
                                  f, targets=targets, train=True))([jnp.asarray(f) for f in feats])
    v = _perturb(v, rng)
    tm = DFINETransformer(**KW, **opt).train(train)
    tm.load_state_dict(flax_to_torch(v["params"], v.get("batch_stats", {}), "decoder"))
    return fm, v, tm, feats


def _flips(jlocs, tlocs):
    """Per decoder layer, the coordinates whose nearest pixel differs between
    the JAX and the port's locations, as readable strings."""
    named = []
    for layer, (jl, tl) in enumerate(zip(jlocs, tlocs)):
        jl, p0 = torch.from_numpy(np.array(jl)), 0
        for lvl, ((H, W), P) in enumerate(zip(SIZES, KW["num_points"])):
            jp, tp = jl[:, :, :, p0:p0 + P], tl[:, :, :, p0:p0 + P]
            differ = discrete_index(jp, H, W) != discrete_index(tp, H, W)
            for i in zip(*np.nonzero(differ.numpy())):
                named.append(f"layer {layer} level {lvl} (b, q, head, point) {tuple(map(int, i))}: "
                             f"JAX loc {jp[i].numpy()}, port {tp[i].numpy()}")
            p0 += P
    return named


@pytest.mark.parametrize("option", ["agnostic", "one2many", "discrete"])
def test_decoder_option_eval_matches_flax(option, monkeypatch):
    fm, v, tm, feats = _decoder_pair(option)

    jlocs = []  # JAX's sampling locations, layer by layer, out of the jitted apply
    sample = jdec.ms_deform_attn

    def spy(value, shapes, loc, *args, **kw):
        jlocs.append(loc)
        return sample(value, shapes, loc, *args, **kw)

    monkeypatch.setattr(jdec, "ms_deform_attn", spy)

    def apply(f):
        jlocs.clear()
        return fm.apply(v, f, train=False), list(jlocs)

    want, jlocs_out = jax.jit(apply)([jnp.asarray(f) for f in feats])

    tlocs = []
    hooks = [layer.cross_attn.register_forward_hook(
        lambda m, args, out: tlocs.append(m.locations(args[0], args[1])[0].detach()))
        for layer in tm.decoder.layers]

    def no_kernel(*a, **k):
        raise AssertionError("the bilinear MSDA ran for a discrete model")

    if option == "discrete":
        monkeypatch.setattr(tdec, "msda", no_kernel)
    with torch.no_grad():
        got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for h in hooks:
        h.remove()

    assert len(tlocs) == len(jlocs_out) == KW["num_layers"]
    if option == "discrete":
        flips = _flips(jlocs_out, tlocs)
        assert not flips, "nearest pixels differ:\n" + "\n".join(flips)
    if option == "agnostic":
        assert tuple(tm.enc_score_head.weight.shape) == (1, 32)
    if option == "one2many":  # some anchor was chosen for two classes: equal queries
        boxes = got["pred_boxes"][0].numpy()
        assert len(np.unique(boxes, axis=0)) < Q
    for k in ("pred_logits", "pred_boxes"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)


def _gt(rng, n_valid=(3, 5)):
    G = 6
    valid = np.arange(G)[None] < np.asarray(n_valid)[:, None]
    cxcy = rng.uniform(0.2, 0.8, (B, G, 2))
    wh = rng.uniform(0.05, 0.4, (B, G, 2))
    return {"labels": np.where(valid, rng.integers(0, NC, (B, G)), NC).astype(np.int32),
            "boxes": np.concatenate([cxcy, wh], -1).astype(np.float32), "valid": valid}


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_torch(v) for v in x]
    return torch.from_numpy(np.array(x))


def test_agnostic_train_outputs_and_criterion_match_jax():
    fm, v, tm, feats = _decoder_pair("agnostic", train=True)
    want = jax.device_get(jax.jit(lambda f: fm.apply(v, f, train=True))(
        [jnp.asarray(f) for f in feats]))
    with torch.no_grad():
        got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    assert got["enc_meta"] == {"class_agnostic": True} == want["enc_meta"]
    (genc,), (wenc,) = got["enc_aux_outputs"], want["enc_aux_outputs"]
    assert genc["pred_logits"].shape == (B, Q, 1)
    for k in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(genc[k].numpy(), wenc[k], **TOL, err_msg=f"enc {k}")
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL, err_msg=k)

    # the criterion on JAX's outputs, on both sides
    cfg = tiny_config()
    t = _gt(np.random.default_rng(2))
    statics = {"up": 0.5, "reg_scale": 4.0, "enc_meta": {"class_agnostic": True}}
    arrays = {k: want[k] for k in ("pred_logits", "pred_boxes", "pred_corners", "ref_points",
                                   "aux_outputs", "pre_outputs", "enc_aux_outputs")}
    jcrit = JCriterion(cfg.criterion, cfg.matcher, num_classes=NC, num_queries=Q)
    wl = jax.device_get(jax.jit(lambda a, tg: jcrit({**a, **statics}, tg))(
        arrays, {k: jnp.asarray(x) for k, x in t.items()}))
    tcfg = port_config(cfg)
    gl = DFINECriterion(tcfg.criterion, tcfg.matcher, num_classes=NC)(
        {**_to_torch(arrays), **statics}, _to_torch(t))
    assert set(gl) == set(wl), sorted(set(gl) ^ set(wl))
    assert {"loss_vfl_enc_0", "loss_bbox_enc_0", "loss_giou_enc_0"} <= set(gl)
    for k, x in wl.items():
        np.testing.assert_allclose(gl[k].item(), float(x), **LOSS_TOL, err_msg=k)


def test_matching_cost_of_one_column_set_matches_jax():
    """A 1-column encoder set is costed on column 0 for every label: the
    port clamps the labels to the logits' width, as JAX's clip does."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(B, 9, 1)).astype(np.float32) * 2
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, 9, 2)), rng.uniform(0.05, 0.4, (B, 9, 2))],
                           -1).astype(np.float32)
    t = _gt(rng)
    cfg = tiny_config().matcher
    want = np.asarray(jmatcher.matching_cost(*(jnp.asarray(a) for a in (
        logits, boxes, t["labels"], t["boxes"])), cfg))
    tcfg = port_config(tiny_config()).matcher
    args = [torch.from_numpy(a) for a in (logits, boxes, t["labels"], t["boxes"])]
    got = tmatcher.matching_cost(*args, tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    args[2] = torch.zeros_like(args[2])
    np.testing.assert_array_equal(tmatcher.matching_cost(*args, tcfg).numpy(), got.numpy())


# ---------------------------------------------------------------- the weights
def _agnostic(cfg):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, query_select_method="agnostic"))


def test_agnostic_weights_and_checkpoints():
    torch.manual_seed(3)
    model = DFINE(_agnostic(get_model_config("n")), num_classes=80)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sd["decoder.enc_score_head.weight"].shape == (1, 128)
    jcfg = _agnostic(jax_config("n"))
    G = jcfg.max_gt
    targets = {"labels": jnp.zeros((1, G), jnp.int32), "boxes": jnp.full((1, G, 4), 0.5),
               "valid": jnp.zeros((1, G), bool).at[:, 0].set(True)}
    shapes = jax.eval_shape(lambda: JaxDFINE(cfg=jcfg, num_classes=80).init(
        {"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1)},
        jnp.zeros((1, 256, 256, 3)), targets=targets, train=True))
    params, stats, report = jconvert.convert_torch_state(sd, shapes["params"],
                                                         shapes["batch_stats"])
    assert report == {"unmatched": [], "shape_mismatch": [], "missed": []}, report
    back = flax_to_torch(params, stats)
    assert set(back) == set(sd)
    for k, x in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), x, err_msg=k)

    # a default (80-row) checkpoint: the head is reported and skipped on both sides
    default = DFINE(get_model_config("n"), num_classes=80).state_dict()
    rep = load_matched(model, default)
    head = ["decoder.enc_score_head.weight", "decoder.enc_score_head.bias"]
    assert rep["shape_mismatch"] == head and not rep["missed"] and not rep["unmatched"]
    assert torch.equal(model.state_dict()["decoder.enc_score_head.weight"],
                       torch.from_numpy(sd["decoder.enc_score_head.weight"]))
    assert torch.equal(model.state_dict()["decoder.dec_score_head.0.weight"],
                       default["decoder.dec_score_head.0.weight"])
    _, _, jrep = jconvert.convert_torch_state({k: v.numpy() for k, v in default.items()},
                                              shapes["params"], shapes["batch_stats"],
                                              strict=False)
    assert sorted(m[0] for m in jrep["shape_mismatch"]) == sorted(head), jrep["shape_mismatch"]

    # an Objects365 checkpoint into an agnostic model: the 1-row head stays
    obj = dict(sd, **{"decoder.dec_score_head.0.bias": np.arange(366, dtype=np.float32)})
    got = remap_obj365_head(obj, 80)
    want = jconvert.remap_obj365_head(obj, 80)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    np.testing.assert_array_equal(got["decoder.enc_score_head.weight"],
                                  sd["decoder.enc_score_head.weight"])
    assert got["decoder.dec_score_head.0.bias"].shape == (80,)
