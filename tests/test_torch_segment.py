"""The mask head slice of the port (task "segment") against the JAX package
on the CPU, on tests/helpers.py:tiny_config(enable_mask_head=True) (masks at
IMG/8, as tests/test_segment_task.py), 4 classes, the same weights on both
sides (the port's seeded init, conv kernels x sqrt(6) so that query
selection does not tie, carried into flax by convert_torch_state and back
by utils/weights.flax_to_torch).

  - MaskDecoder alone against flax's, f32, rtol = atol = 1e-5, on three
    levels at the canvases 640^2 (80/40/20), 608^2 (76/38/19) and 704^2
    (88/44/22), on levels that are not whole multiples of each other
    (13x17, 7x9, 4x5) and on two levels; the resize alone
    (jax.image.resize "bilinear" against F.interpolate, align_corners=False)
    at 1e-6 on the same shapes;
  - the segment model's eval outputs (pred_masks are probabilities) at the
    serving tolerance, atol 1e-4; its train-mode sets (final, aux, dn, with
    the aux/dn masks and dn_pred_masks, which are logits) at atol 1e-4
    against the JAX forward under the same denoising draws;
  - mask_matching_cost and loss_masks on random logits at rtol = atol = 1e-5;
  - one train step with masks: every loss term (the loss_mask_* terms of the
    final, _aux_i, _dn_i and _dn_final sets among them), the gradients and
    the step's metrics against jax.value_and_grad of the JAX package's loss,
    at tests/test_torch_train_step.py's tolerances: losses rtol 1e-4, the
    global gradient norm 6e-3, each gradient tensor outside the backbone 5e-3
    (relative L2). The backbone's gradient is ill-conditioned at this size
    (a ReLU input within f32 rounding of zero moves the JAX package's f32
    side; that file's docstring and tests/test_torch_train_grad_f64.py): on
    this batch it is held as a whole at 2e-2 (measured 9.9e-3; one
    BatchNorm bias of stages.0 strays 1.3e-2), and those two files hold it
    closer;
  - TorchModel(task="segment") against JaxModel from one .pt file, float32
    and int8: detections as in tests/test_torch_runtime.py, and the uint8
    masks in the original frame equal except where the resized probability
    lies within 1e-4 of 0.5;
  - the Trainer's get_preds_and_gt on a polygon-labelled YOLO set: the GT
    masks_rle equal to the JAX Trainer's, the predicted ones equal except
    where the resized probability lies within 1e-4 of 0.5, and the mask
    decision metrics (mAP_50_mask) of both;
  - the int8 set of names against JAX's quantize_params paths through the
    bridge.
"""

import dataclasses
import math
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from custom_d_fine_tpu.deploy import quantize as jq
from custom_d_fine_tpu.infer import model as jinfer
from custom_d_fine_tpu.models import decoder as jdecoder
from custom_d_fine_tpu.models import dfine as jdfine
from custom_d_fine_tpu.train.criterion import DFINECriterion as JCriterion
from custom_d_fine_tpu.train.criterion import loss_masks as jloss_masks
from custom_d_fine_tpu.train.matcher import mask_matching_cost as jmask_cost
from custom_d_fine_tpu_torch.deploy import quantize as tq
from custom_d_fine_tpu_torch.infer import model as tinfer
from custom_d_fine_tpu_torch.models.decoder import MaskDecoder, resize_bilinear
from custom_d_fine_tpu_torch.models.dfine import build_model as tbuild
from custom_d_fine_tpu_torch.train import train_step as ttrain
from custom_d_fine_tpu_torch.train.criterion import DFINECriterion, loss_masks, with_mask_losses
from custom_d_fine_tpu_torch.train.matcher import mask_matching_cost
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch, flax_train_state_to_torch

from helpers import make_targets, tiny_config
from test_torch_train_step import (DN_KEY, GRAD_FLOOR, GRAD_NORM_RTOL, GRAD_RTOL, LOSS_TOL,
                                   _region, jax_dn_draws, port_config)
from torch_jax_models import flax_variables, port_weights, shape_only_build_model
from torch_threads import few_threads  # noqa: F401  (autouse)

IMG, B, NC, MASK_DS = 160, 2, 4, 8
LR = dict(base_lr=2.5e-4, backbone_lr=6e-5, total_steps=100)
TOL = 1e-4

LEVELS = {
    "640": [(80, 80), (40, 40), (20, 20)],
    "608": [(76, 76), (38, 38), (19, 19)],
    "704": [(88, 88), (44, 44), (22, 22)],
    "non_multiple": [(13, 17), (7, 9), (4, 5)],
    "two_levels": [(10, 10), (5, 5)],
}


def _seg_targets(cfg, rng, n_valid=3):
    """make_targets with box-shaped masks at IMG/MASK_DS (test_segment_task.py)."""
    t = {k: np.asarray(v) for k, v in make_targets(B, cfg.max_gt, NC, rng, n_valid).items()}
    m = IMG // MASK_DS
    masks = np.zeros((B, cfg.max_gt, m, m), np.uint8)
    for b in range(B):
        for g in range(n_valid):
            cx, cy, w, h = t["boxes"][b, g]
            masks[b, g, int((cy - h / 2) * m):int((cy + h / 2) * m),
                  int((cx - w / 2) * m):int((cx + w / 2) * m)] = 1
    t["masks"] = masks
    return t


@pytest.fixture(scope="module")
def seg():
    """The segment tiny model on both sides, the same weights, a batch."""
    jcfg = tiny_config(enable_mask_head=True)
    jcfg = dataclasses.replace(jcfg, criterion=dataclasses.replace(
        jcfg.criterion, losses=tuple(jcfg.criterion.losses) + ("masks",)))
    tcfg = port_config(jcfg)
    sd = port_weights(tcfg, NC)
    jmodel, variables = flax_variables(jcfg, sd, (IMG, IMG), NC)
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (B, IMG, IMG, 3)).astype(np.uint8),
             **_seg_targets(jcfg, rng)}
    return SimpleNamespace(jcfg=jcfg, tcfg=tcfg, sd=sd, jmodel=jmodel, variables=variables,
                           batch=batch, draws=jax_dn_draws(jcfg, B, NC))


def _port_model(seg, train=False):
    m = tbuild(seg.tcfg, NC)
    m.load_state_dict(seg.sd)
    return m.train(train)


def _nchw(images_u8):
    return torch.from_numpy(images_u8).float().div(255.0).permute(0, 3, 1, 2)


# ------------------------------------------------------------------ MaskDecoder

@pytest.mark.parametrize("case", list(LEVELS))
def test_resize_matches_jax_image_resize(case):
    """Every resize of the mask head is an upsample: to the finest level, and
    the 2x after the fusion conv."""
    levels = LEVELS[case]
    rng = np.random.default_rng(1)
    targets = [levels[0], (2 * levels[0][0], 2 * levels[0][1])]
    for (h, w), (H, W) in [(lv, targets[0]) for lv in levels[1:]] + [(levels[0], targets[1])]:
        x = rng.normal(size=(2, h, w, 8)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, H, W, 8), method="bilinear"))
        got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (H, W))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{(h, w)} -> {(H, W)}")


@pytest.mark.parametrize("case", list(LEVELS))
def test_mask_decoder_matches_flax(case):
    levels, c_in, out_ch = LEVELS[case], 32, 64
    rng = np.random.default_rng(2)
    feats = [rng.normal(size=(1, h, w, c_in)).astype(np.float32) for h, w in levels]
    jmd = jdecoder.MaskDecoder(out_ch)
    shapes = jax.eval_shape(lambda: jmd.init(jax.random.PRNGKey(0),
                                             [jnp.asarray(f) for f in feats]))
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0.3, 0.2, s.shape).astype(np.float32), shapes["params"])
    want = np.asarray(jax.jit(jmd.apply)({"params": params}, [jnp.asarray(f) for f in feats]))

    tmd = MaskDecoder([c_in] * len(levels), out_ch)
    tmd.load_state_dict(flax_to_torch(params, {}))
    with torch.no_grad():
        got = tmd([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    assert got.shape == (1, out_ch, 2 * levels[0][0], 2 * levels[0][1])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- the segment model

@pytest.fixture(scope="module")
def jax_step(seg):
    """jax.value_and_grad of make_train_step's loss_fn (train_step.py:75-88)
    with the masks in the targets, returning the train-mode outputs too."""
    jcfg = seg.jcfg
    criterion = JCriterion(jcfg.criterion, jcfg.matcher, num_classes=NC,
                           num_queries=jcfg.decoder.num_queries)

    def loss_fn(params, batch):
        images = batch["images"].astype(jnp.float32) / 255.0
        targets = {k: batch[k] for k in ("labels", "boxes", "valid", "masks")}
        outputs, mutated = seg.jmodel.apply(
            {"params": params, "batch_stats": seg.variables["batch_stats"]}, images,
            targets=targets, train=True, rngs={"dn": DN_KEY}, mutable=["batch_stats"])
        losses = criterion(outputs, targets)
        outputs = {k: v for k, v in outputs.items() if k not in ("dn_meta", "enc_meta")}
        return jnp.sum(jnp.stack(list(losses.values()))), (losses, outputs)

    def grad_fn(params, batch):
        out, grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch)
        return out, grads, optax.global_norm(grads)

    orig = jdecoder.build_cdn_group
    with pytest.MonkeyPatch.context() as mp:  # traced under the fixed key
        mp.setattr(jdecoder, "build_cdn_group", lambda rng, *a, **k: orig(DN_KEY, *a, **k))
        (total, (losses, outputs)), grads, gnorm = jax.device_get(jax.jit(grad_fn)(
            seg.variables["params"], {k: jnp.asarray(v) for k, v in seg.batch.items()}))
    return SimpleNamespace(total=total, losses=losses, outputs=outputs, grads=grads,
                           grad_norm=gnorm)


def _targets(batch):
    return {k: torch.from_numpy(batch[k]) for k in ("labels", "boxes", "valid", "masks")}


def test_segment_train_sets_match_jax(seg, jax_step):
    model = _port_model(seg, train=True)
    with torch.no_grad():
        got = model(_nchw(seg.batch["images"]), targets=_targets(seg.batch), dn_draws=seg.draws)
    want = jax_step.outputs
    n_layers = seg.jcfg.decoder.num_layers

    def same(g, w, what):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL, err_msg=what)

    for k in ("pred_logits", "pred_boxes", "pred_masks", "dn_pred_masks"):
        same(got[k], want[k], k)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == n_layers - 1
    for i, (g, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        assert "pred_masks" in g
        for k in ("pred_logits", "pred_masks"):
            same(g[k], w[k], f"aux {i} {k}")
    # the dn sets carry masks on all but the last, which is dn_pred_masks
    assert [("pred_masks" in g) for g in got["dn_outputs"]] == \
        [("pred_masks" in w) for w in want["dn_outputs"]] == [True] * (n_layers - 1) + [False]
    for i, (g, w) in enumerate(zip(got["dn_outputs"][:-1], want["dn_outputs"][:-1])):
        same(g["pred_masks"], w["pred_masks"], f"dn {i} pred_masks")


def test_mask_matching_cost_and_loss_masks_match_jax(seg):
    cfg = seg.jcfg
    rng = np.random.default_rng(3)
    Q, G, m = 12, 5, 16
    logits = (rng.normal(size=(B, Q, m, m)) * 3).astype(np.float32)
    t = _seg_targets(cfg, rng)
    tmasks = (rng.uniform(size=(B, G, m, m)) < 0.3).astype(np.uint8)
    want = np.asarray(jmask_cost(jnp.asarray(logits), jnp.asarray(tmasks), cfg.matcher))
    got = mask_matching_cost(torch.from_numpy(logits), torch.from_numpy(tmasks),
                             seg.tcfg.matcher).numpy()
    assert got.shape == (B, Q, G)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    match = {"q": rng.integers(0, Q, (B, G)).astype(np.int32),
             "g": rng.permutation(G)[None].repeat(B, 0).astype(np.int32),
             "valid": rng.uniform(size=(B, G)) < 0.7}
    outputs = {"pred_masks": logits}
    targets = {"masks": tmasks, "boxes": t["boxes"][:, :G]}
    want = jloss_masks(jax.tree_util.tree_map(jnp.asarray, outputs),
                       jax.tree_util.tree_map(jnp.asarray, targets),
                       jax.tree_util.tree_map(jnp.asarray, match), None)
    tmatch = {k: torch.from_numpy(np.asarray(v)) for k, v in match.items()}
    got = loss_masks({"pred_masks": torch.from_numpy(logits)},
                     {k: torch.from_numpy(v) for k, v in targets.items()}, tmatch,
                     tmatch["valid"].float().sum().clamp(min=1.0))
    assert set(got) == set(want) == {"loss_mask_bce", "loss_mask_dice"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_segment_train_step_matches_jax(seg, jax_step):
    """Losses and gradients of the port's forward + criterion on the initial
    state, then one whole step of build_training: its metrics against the
    JAX step's loss and global gradient norm. (The update that follows is
    AdamW on these gradients, held against optax in
    tests/test_torch_optim.py.)"""
    model = _port_model(seg, train=True)
    crit = DFINECriterion(seg.tcfg.criterion, seg.tcfg.matcher, num_classes=NC)
    targets = _targets(seg.batch)
    got = crit(model(_nchw(seg.batch["images"]), targets=targets, dn_draws=seg.draws), targets)
    n_layers = seg.jcfg.decoder.num_layers
    mask_keys = {f"loss_mask_{t}{s}" for t in ("bce", "dice") for s in
                 ["", "_dn_final"] + [f"_aux_{i}" for i in range(n_layers - 1)]
                 + [f"_dn_{i}" for i in range(n_layers - 1)]}
    assert mask_keys <= set(got) and set(got) == set(jax_step.losses)
    for k, v in jax_step.losses.items():
        np.testing.assert_allclose(got[k].item(), v, **LOSS_TOL, err_msg=k)
    torch.stack(list(got.values())).sum().backward()
    want = {k: v.double() for k, v in flax_to_torch(jax_step.grads, {}).items()}
    grads = {k: p.grad.double() for k, p in model.named_parameters()}
    assert set(want) == set(grads)
    norm = math.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    for k, w in want.items():
        if _region(k) == "other" and w.norm() >= GRAD_FLOOR["other"] * norm:
            rel = float((grads[k] - w).norm() / w.norm())
            assert rel <= GRAD_RTOL["other"], f"{k}: relative L2 error {rel:.2e}"
    bb = [k for k in want if _region(k) == "backbone"]
    rel = math.sqrt(sum(float(((grads[k] - want[k]) ** 2).sum()) for k in bb)
                    / sum(float((want[k] ** 2).sum()) for k in bb))
    assert rel <= 2e-2, f"backbone gradient: relative L2 error {rel:.2e}"

    v = seg.variables
    sd, ema = flax_train_state_to_torch(v["params"], v["batch_stats"], v)
    step, state = ttrain.build_training(seg.tcfg, NC, device="cpu", bf16=False, state_dict=sd,
                                        ema=ema, **LR)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "draw_dn_noise", lambda *a, **k: seg.draws)
        state, metrics = step(state, {k: torch.from_numpy(t) for k, t in seg.batch.items()},
                              torch.Generator())
    assert set(metrics) == set(jax_step.losses) | {"total_loss", "grad_norm"}
    for k, v in jax_step.losses.items():
        np.testing.assert_allclose(float(metrics[k]), v, **LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(float(metrics["total_loss"]), jax_step.total, **LOSS_TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jax_step.grad_norm,
                               rtol=GRAD_NORM_RTOL)
    assert state.step == 1


def test_with_mask_losses_adds_masks_once():
    cfg = port_config(tiny_config(enable_mask_head=True)).criterion
    assert "masks" not in cfg.losses
    once = with_mask_losses(cfg)
    assert once.losses == tuple(cfg.losses) + ("masks",) and with_mask_losses(once) == once


# ------------------------------------------------------------------ deploy

def test_quantized_names_match_jax_through_the_bridge(seg):
    _, jpaths = jq.quantize_params(seg.variables["params"])
    jset = set(jpaths)
    assert any(p.startswith("decoder/mask_decoder/") for p in jset)
    marks = jax.tree_util.tree_map_with_path(
        lambda p, v: np.full(v.shape, "/".join(k.key for k in p) in jset, np.float32),
        seg.variables["params"])
    sd = flax_to_torch(marks, jax.tree_util.tree_map(np.zeros_like,
                                                     seg.variables["batch_stats"]))
    marked = {k for k, v in sd.items() if v.numel() and bool((v == 1).all())}
    names = tq.quantizable_names(_port_model(seg))
    assert set(names) == marked
    assert {"decoder.mask_decoder.up_conv.weight", "decoder.mask_head.layers.2.weight"} <= marked


@pytest.fixture(scope="module")
def ckpt(seg, tmp_path_factory):
    path = tmp_path_factory.mktemp("segckpt") / "model.pt"
    torch.save({"model": seg.sd, "ema": {"module": seg.sd}}, path)
    return path


def _frames():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (200, 300, 3)).astype(np.uint8),
            rng.integers(0, 256, (330, 180, 3)).astype(np.uint8)]


def _robust(scores):
    gap = np.full(scores.shape, np.inf)
    d = np.abs(np.diff(scores))
    gap[:-1] = np.minimum(gap[:-1], d)
    gap[1:] = np.minimum(gap[1:], d)
    return gap > TOL


def _near_half(prob, oh, ow):
    """Pixels of the original frame where a mask's resized probability lies
    within 1e-4 of 0.5: there a binarisation may go either way."""
    return np.abs(cv2.resize(prob.astype(np.float32), (ow, oh),
                             interpolation=cv2.INTER_LINEAR) - 0.5) < 1e-4


@pytest.fixture(scope="module")
def runtimes(seg, ckpt):
    """JaxModel and TorchModel(task="segment") from one .pt file, both on the
    tiny config in place of a registry size, keep_ratio on, conf 0 (every
    one of the 240 top-K detections kept); the JaxModel's build_model skips
    its init compile (torch_jax_models.shape_only_build_model). One JaxModel
    serves float32 and int8: its int8 forward is the JAX package's
    make_serving_forward (quantize_int8=True) on the same model and
    variables, as JaxModel builds it, with the stem's kernels left in f32:
    that is its TPU graph (the fused stem keeps f32 weights) and the port's
    graph, where on the CPU, running the flax stem, it would quantize those
    too (tests/test_torch_quantize.py builds the same reference)."""
    from custom_d_fine_tpu.deploy.serving import make_serving_forward as jserving

    kw = dict(img_size=(IMG, IMG), task="segment", conf_thresh=0.0, keep_ratio=True,
              smoke_test=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinfer, "get_model_config", lambda *a, **k: seg.jcfg)
        mp.setattr(tinfer, "get_model_config", lambda *a, **k: seg.tcfg)
        mp.setattr(jdfine, "build_model", shape_only_build_model)
        jm = jinfer.JaxModel(str(ckpt), "tiny", NC, **kw)
        tms = {d: tinfer.TorchModel(str(ckpt), "tiny", NC, device="cpu", dtype=d, **kw)
               for d in ("float32", "int8")}
        orig = jq.quantize_params

        def quantize_but_the_stem(params, skip=None):
            paths = {"/".join(k.key for k in p)
                     for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
            stem = {p for p in paths if p.startswith("backbone/stem/") and p.endswith("kernel")}
            assert len(stem) == 5
            return orig(params, skip=set(skip or ()) | stem)

        mp.setattr(jq, "quantize_params", quantize_but_the_stem)
        infer = {"float32": jm._infer, "int8": jax.jit(jserving(
            jm.model, jm.variables, (IMG, IMG), quantize_int8=True))}
    return jm, infer, tms


def test_segment_eval_forward_matches_jax(seg, runtimes):
    """The serving forward's top-K of the eval outputs (the masks are the
    probabilities of the detections' queries) on the same canvases."""
    jm, infer, tms = runtimes
    with torch.no_grad():
        out = _port_model(seg)(_nchw(seg.batch["images"]))
    m = IMG // MASK_DS
    assert set(out) == {"pred_logits", "pred_boxes", "pred_masks"}
    assert out["pred_masks"].shape == (B, seg.jcfg.decoder.num_queries, m, m)
    assert 0 <= float(out["pred_masks"].min()) and float(out["pred_masks"].max()) <= 1
    got = {k: v.numpy() for k, v in tms["float32"].infer(torch.from_numpy(
        seg.batch["images"])).items()}
    want = jax.device_get(infer["float32"](jnp.asarray(seg.batch["images"])))
    assert set(got) == set(want) == {"labels", "boxes", "scores", "masks"}
    assert got["masks"].shape == (B, 240, m, m)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL)
    for b in range(B):
        keep = _robust(got["scores"][b]) & _robust(want["scores"][b])
        assert keep.sum() >= 20
        np.testing.assert_array_equal(got["labels"][b][keep], want["labels"][b][keep])
        np.testing.assert_allclose(got["boxes"][b][keep], want["boxes"][b][keep],
                                   atol=TOL * IMG)
        np.testing.assert_allclose(got["masks"][b][keep], want["masks"][b][keep], atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_torch_model_segment_matches_jax_runtime(runtimes, dtype):
    jm, infer, tms = runtimes
    tm = tms[dtype]
    jm._infer = infer[dtype]
    for img in _frames():
        oh, ow = img.shape[:2]
        got, want = tm(img)[0], jm(img)[0]
        assert got.keys() == want.keys() == {"labels", "boxes", "scores", "masks"}
        np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL)
        keep = _robust(got["scores"]) & _robust(want["scores"])
        assert keep.sum() >= 20
        np.testing.assert_array_equal(got["labels"][keep], want["labels"][keep])
        np.testing.assert_allclose(got["boxes"][keep], want["boxes"][keep],
                                   atol=TOL * max(oh, ow))
        assert got["masks"].dtype == np.uint8 and got["masks"].shape == (len(got["scores"]),
                                                                          oh, ow)
        for mask, box in zip(got["masks"], got["boxes"]):  # zero outside the box
            x1, y1, x2, y2 = (int(v) for v in box)
            inside = np.zeros_like(mask)
            inside[max(y1, 0):y2, max(x1, 0):x2] = 1
            assert not (mask & (1 - inside)).any()
        canvas, _, _ = tm._prepare(img)  # conf 0, no NMS: the top-K in order
        probs = tm.infer(torch.from_numpy(canvas[None]))["masks"][0].numpy()
        for i in np.flatnonzero(keep):
            differ = got["masks"][i] != want["masks"][i]
            assert not (differ & ~_near_half(probs[i], oh, ow)).any(), f"mask {i}"
        assert got["masks"][keep].any()


def test_infer_folder_writes_polygons(runtimes, tmp_path):
    """cli/infer.py's folder inference with task "segment" writes each
    detection with a non-empty mask as a YOLO-seg polygon row (class, then
    x y pairs normalised to the image)."""
    from custom_d_fine_tpu_torch.cli.infer import infer_folder

    _, _, tms = runtimes
    src = tmp_path / "src"
    src.mkdir()
    for i, img in enumerate(_frames()):
        cv2.imwrite(str(src / f"im{i}.png"), img)
    infer_folder(tms["float32"], src, tmp_path / "out", {i: f"c{i}" for i in range(NC)},
                 task="segment")
    for i, img in enumerate(_frames()):
        det = tms["float32"](img)[0]
        rows = [r.split() for r in (tmp_path / "out" / "labels" / f"im{i}.txt")
                .read_text().splitlines()]
        assert len(rows) == len(det["scores"])
        polys = [r for r in rows if len(r) >= 7]
        assert 0 < len(polys) <= sum(bool(m.any()) for m in det["masks"])
        for r in polys:
            xy = np.array(r[1:], float)
            assert len(xy) % 2 == 0 and ((xy >= 0) & (xy <= 1)).all()


# ------------------------------------------------------------------ the Trainer

@pytest.fixture(scope="module")
def seg_dataset(tmp_path_factory):
    """12 train + 4 val JPEGs of 200x200, each with a red triangle and a
    blue rectangle labelled as YOLO-seg polygons (normalised)."""
    root = tmp_path_factory.mktemp("segds")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    names = []
    for i in range(16):
        img = rng.integers(0, 255, (200, 200, 3)).astype(np.uint8)
        x, y = rng.integers(20, 100, 2)
        tri = np.array([[x, y], [x + 70, y + 10], [x + 20, y + 80]], np.int32)
        cv2.fillPoly(img, [tri], (32, 32, 255))
        rx, ry = rng.integers(10, 130, 2)
        rect = np.array([[rx, ry], [rx + 50, ry], [rx + 50, ry + 40], [rx, ry + 40]], np.int32)
        cv2.fillPoly(img, [rect], (255, 64, 32))
        name = f"im{i}.jpg"
        cv2.imwrite(str(root / "images" / name), img)
        rows = [f"{c} " + " ".join(f"{v / 200:.5f}" for v in poly.reshape(-1))
                for c, poly in ((0, tri), (1, rect))]
        (root / "labels" / f"im{i}.txt").write_text("\n".join(rows) + "\n")
        names.append(name)
    (root / "train.csv").write_text("\n".join(names[:12]) + "\n")
    (root / "val.csv").write_text("\n".join(names[12:]) + "\n")
    return root


def _trainer_overrides(root, save):
    kw = {"train.data_path": root, "train.path_to_save": save, "train.epochs": 1,
          "train.batch_size": 4, "train.num_workers": 1, "train.img_size": f"[{IMG},{IMG}]",
          "train.max_gt": 10, "train.label_to_name": "{0: tri, 1: rect, 2: c2, 3: c3}",
          "train.conf_thresh": 0.0, "train.decision_metrics": "[mAP_50, f1]",
          "train.dtype": "float32", "model_name": "n", "task": "segment", "exp_name": "seg"}
    return [f"{k}={v}" for k, v in kw.items()]


def test_trainer_segment_preds_and_gt_match_jax(seg, seg_dataset, tmp_path):
    from custom_d_fine_tpu.train.trainer import Trainer as JTrainer
    from custom_d_fine_tpu.utils.config import load_config as jload_config
    from custom_d_fine_tpu_torch.eval.rle import rle_to_masks
    from custom_d_fine_tpu_torch.eval.validator import Validator
    from custom_d_fine_tpu_torch.train.trainer import Trainer
    from custom_d_fine_tpu_torch.utils.config import load_config

    from custom_d_fine_tpu.train import trainer as jtrainer

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "build_model", shape_only_build_model)
        jt = JTrainer(jload_config(overrides=_trainer_overrides(seg_dataset, tmp_path / "j")),
                      model_cfg_override=seg.jcfg)
    jt.state = jt.state._replace(ema=jax.device_put(seg.variables, jt.repl))
    jpreds, jgts = jt.get_preds_and_gt("val", visualize=False)

    tt = Trainer(load_config(overrides=_trainer_overrides(seg_dataset, tmp_path / "t")
                             + ["train.device=cpu"]), model_cfg_override=seg.tcfg)
    assert tt.decision_metrics == jt.decision_metrics == ["mAP_50_mask", "f1"]
    tt.state.model.load_state_dict(seg.sd)
    for k, v in tt.state.model.state_dict().items():
        tt.state.ema[k].copy_(v)
    tpreds, tgts = tt.get_preds_and_gt("val", visualize=False)

    assert len(tpreds) == len(jpreds) == 4
    for tg, jg in zip(tgts, jgts):
        assert len(tg["masks_rle"]) == len(jg["labels"]) == 2
        assert tg["masks_rle"] == jg["masks_rle"]
    # the port's own mask probabilities say where a binarisation may flip
    batch = next(iter(tt.loader.epoch_iterator("val", shuffle=False, drop_last=False)))
    probs = tt.eval_step(tt.state, torch.from_numpy(batch["images"]))["masks"].numpy()
    n_masks = 0
    for b, (tp, jp) in enumerate(zip(tpreds, jpreds)):
        np.testing.assert_allclose(tp["all_scores"], jp["all_scores"], atol=TOL)
        keep = _robust(tp["all_scores"]) & _robust(jp["all_scores"])
        oh, ow = (int(v) for v in batch["orig_sizes"][b])
        tm_, jm_ = rle_to_masks(tp["masks_rle"]), rle_to_masks(jp["masks_rle"])
        assert len(tm_) == len(jm_) == len(tp["scores"])
        for i in np.flatnonzero(keep):
            differ = tm_[i] != jm_[i]
            assert not (differ & ~_near_half(probs[b, i], oh, ow)).any(), f"image {b} mask {i}"
            n_masks += 1
    assert n_masks >= 40
    metrics = {}
    for name, (p, g) in {"torch": (tpreds, tgts), "jax": (jpreds, jgts)}.items():
        metrics[name] = Validator(g, p, tt.label_to_name, conf_thresh=0.0,
                                  iou_thresh=tt.iou_thresh).compute_metrics()
    for k in ("mAP_50_mask", "mAP_50_95_mask"):
        np.testing.assert_allclose(metrics["torch"][k], metrics["jax"][k], atol=1e-3, err_msg=k)
