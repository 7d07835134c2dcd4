"""Denoising, matching and the criterion of the port (models/denoising.py,
ops/hungarian.py, train/matcher.py, train/criterion.py) against the JAX
package's, on the same numpy-seeded inputs:
  - build_cdn_group with the random draws JAX makes from the same key
    injected, dn_layout and the DN attention mask;
  - matching_cost element by element, focal and softmax;
  - the exact assignment: its optimal cost equal to the JAX package's
    on-device LAPJV (ops/lapjv.py); indices are not compared, since ties may
    pick another optimum;
  - host_go_union against the JAX package's host_go_union and on-device
    go_union on the same assignment; match_topk on tie-free costs;
  - every loss term of DFINECriterion on the same outputs dict and targets,
    with and without image_valid.
Tolerances (f32 on both sides, the same formulas in another order):
matching costs rtol 1e-5, atol 1e-6; the optimal cost rtol 1e-6; loss
terms rtol 1e-5, atol 1e-7; integer outputs exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.models import denoising as jdn
from custom_d_fine_tpu.ops import hungarian as jhung
from custom_d_fine_tpu.ops.lapjv import batched_assignment, go_union
from custom_d_fine_tpu.train import matcher as jmatcher
from custom_d_fine_tpu.train.criterion import DFINECriterion as JCriterion
from custom_d_fine_tpu_torch.configs import registry as treg
from custom_d_fine_tpu_torch.models import denoising as tdn
from custom_d_fine_tpu_torch.ops.hungarian import host_go_union, host_solve
from custom_d_fine_tpu_torch.train import matcher as tmatcher
from custom_d_fine_tpu_torch.train.criterion import DFINECriterion

from helpers import tiny_config
from test_torch_train_step import port_config

NC, B, G, GD = 4, 3, 6, 5
COST_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)


def _boxes(rng, *shape):
    cxcy = rng.uniform(0.2, 0.8, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([cxcy, wh], -1).astype(np.float32)


def _targets(rng, n_valid=(3, 0, 6)):
    """Padded targets: 3 GTs, none, and more GTs (6) than dn_max_gt (5)."""
    valid = np.arange(G)[None] < np.asarray(n_valid)[:, None]
    labels = np.where(valid, rng.integers(0, NC, (B, G)), NC).astype(np.int32)
    return {"labels": labels, "boxes": _boxes(rng, B, G), "valid": valid}


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _jax_draws(key, num_dn):
    """build_cdn_group's draws from `key` (denoising.py:102-116)."""
    k_label, k_sign, k_part = jax.random.split(key, 3)
    shape = (B, num_dn)
    return {"flip_u": jax.random.uniform(k_label, shape),
            "new_label": jax.random.randint(k_label, shape, 0, NC, dtype=jnp.int32),
            "sign": jax.random.randint(k_sign, shape + (4,), 0, 2),
            "part": jax.random.uniform(k_part, shape + (4,))}


def _dn_group(t, num_group=2):
    key = jax.random.PRNGKey(7)
    kw = dict(num_classes=NC, num_group=num_group, dn_max_gt=GD, label_noise_ratio=0.5,
              box_noise_scale=1.0)
    want = jax.device_get(jdn.build_cdn_group(key, *(jnp.asarray(t[k]) for k in
                                                     ("labels", "boxes", "valid")), **kw))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in
             _jax_draws(key, 2 * num_group * GD).items()}
    got = tdn.build_cdn_group(*(torch.from_numpy(t[k]) for k in ("labels", "boxes", "valid")),
                              draws, **kw)
    return want, got


def test_build_cdn_group_matches_jax():
    t = _targets(np.random.default_rng(0))
    want, got = _dn_group(t)
    assert set(want) == set(got)
    for k in ("labels", "valid", "positive", "gt_index"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["bbox_unact"].numpy(), np.asarray(want["bbox_unact"]),
                               rtol=1e-5, atol=1e-5)
    # D-FINE-m's training layout: 300 queries + 2 groups x 2 x 50 slots
    assert tdn.dn_layout(100, 50, 300) == jdn.dn_layout(100, 50, 300) == (2, 200, 500)
    for args in ((2, GD, 7), (1, 50, 300)):
        np.testing.assert_array_equal(tdn.build_dn_attn_mask(*args),
                                      jdn.build_dn_attn_mask(*args))


@pytest.mark.parametrize("focal", [True, False])
def test_matching_cost_matches_jax(focal):
    cfg = dataclasses.replace(tiny_config().matcher, use_focal_loss=focal)
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(B, 9, NC)).astype(np.float32) * 2
    boxes = _boxes(rng, B, 9)
    t = _targets(rng)
    want = np.asarray(jmatcher.matching_cost(jnp.asarray(logits), jnp.asarray(boxes),
                                             jnp.asarray(t["labels"]), jnp.asarray(t["boxes"]),
                                             cfg))
    got = tmatcher.matching_cost(torch.from_numpy(logits), torch.from_numpy(boxes),
                                 torch.from_numpy(t["labels"]), torch.from_numpy(t["boxes"]),
                                 treg.MatcherConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(got.numpy(), want, **COST_TOL)


def _optimal(costs, assign):
    S, Bn, _, Gn = costs.shape
    tot = np.zeros((S, Bn))
    for s in range(S):
        for b in range(Bn):
            for g in range(Gn):
                if assign[s, b, g] >= 0:
                    tot[s, b] += costs[s, b, assign[s, b, g], g]
    return tot


def packed(costs, n_valid):
    """Padded costs [S, B, Q, G] in host_solve's packed layout (each image's
    first n_b columns as a row-major [Q, n_b] block, ops/hungarian.py), and
    the valid mask [B, G]."""
    S, _, _, Gn = costs.shape
    blocks = [costs[:, b, :, :n].reshape(S, -1) for b, n in enumerate(n_valid) if n]
    return (np.concatenate(blocks, 1) if blocks else np.zeros((S, 0), costs.dtype),
            np.arange(Gn)[None] < np.asarray(n_valid)[:, None])


def test_assignment_optimal_cost_matches_lapjv():
    """Costs with ties (rounded to 0.25) and without; n_valid 3, 0 and 6."""
    rng = np.random.default_rng(2)
    n_valid = np.array([3, 0, 6])
    for tied in (False, True):
        costs = rng.uniform(0, 4, (2, B, 9, G)).astype(np.float32)
        if tied:
            costs = np.round(costs * 4) / 4
        got = host_solve(*packed(costs, n_valid))
        want = np.asarray(jax.jit(batched_assignment)(jnp.asarray(costs), jnp.asarray(n_valid)))
        for s in range(2):
            for b in range(B):
                a = got[s, b, :n_valid[b]]
                assert (a >= 0).all() and len(set(a)) == len(a)
                assert (got[s, b, n_valid[b]:] == -1).all()
        np.testing.assert_allclose(_optimal(costs, got),
                                   _optimal(costs, np.where(np.arange(G) < n_valid[:, None],
                                                            want, -1)), rtol=1e-6)


@pytest.mark.parametrize("case,n_valid", [("repeats", (3, 0, 6)), ("agree", (3, 1, 6)),
                                          ("tied", (3, 0, 6)), ("no_gt", (0, 0, 0))])
def test_go_union_matches_jax(case, n_valid):
    """The same assignment into the port's host_go_union, the JAX package's
    and its on-device go_union: with repeated pairs, so the counts decide;
    with every set agreeing; with each pair once, so every count ties and
    the smallest GT wins (each beside an image without GT, or with one);
    with no GT in any image."""
    rng = np.random.default_rng(3)
    n_valid = np.array(n_valid)
    Q, S = 8, 5
    assign = np.stack([np.stack([rng.permutation(Q)[:G] for _ in range(B)]) for _ in range(S)])
    if case == "repeats":
        assign[1] = assign[0]
    elif case == "agree":
        assign[:] = assign[0]
    elif case == "tied":  # set s gives GT g the query (g + s) % Q: each (q, g) once
        assign[:] = (np.arange(G)[None, None] + np.arange(S)[:, None, None]) % Q
    assign[:, np.arange(G)[None] >= n_valid[:, None]] = -1
    got = host_go_union(assign, n_valid, Q)
    want = jhung.host_go_union(assign, n_valid, Q)
    valid = np.arange(G)[None] < n_valid[:, None]
    dev = jax.device_get(go_union(jnp.asarray(assign.astype(np.int32)), jnp.asarray(valid), Q))
    for g, w, d in zip(got, want, dev):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.asarray(d))


def test_match_topk_matches_jax():
    rng = np.random.default_rng(4)
    cost = rng.uniform(0, 4, (B, 12, G)).astype(np.float32)
    valid = np.arange(G)[None] < np.array([3, 0, 6])[:, None]
    got = tmatcher.match_topk(torch.from_numpy(cost), torch.from_numpy(valid), 2).numpy()
    want = np.asarray(jmatcher.match_topk(jnp.asarray(cost), jnp.asarray(valid), 2))
    np.testing.assert_array_equal(np.where(valid[None], got, -1), np.where(valid[None], want, -1))


def _criterion_inputs(seed, num_group=2):
    """A train-mode outputs dict of the decoder's structure (2 layers: one
    aux set, the pre and encoder sets, 2 dn layers and the dn pre set)."""
    cfg = tiny_config()
    K1 = cfg.criterion.reg_max + 1
    rng = np.random.default_rng(seed)
    t = _targets(rng)
    dn = jax.device_get(_dn_group(t, num_group)[0])
    num_dn = 2 * num_group * GD
    Q = 12

    def layer(Qn):
        return {"pred_logits": rng.normal(size=(B, Qn, NC)).astype(np.float32) * 2,
                "pred_boxes": _boxes(rng, B, Qn),
                "pred_corners": rng.normal(size=(B, Qn, 4 * K1)).astype(np.float32),
                "ref_points": _boxes(rng, B, Qn)}

    def with_teacher(layers):
        return [{**l, "teacher_corners": layers[-1]["pred_corners"],
                 "teacher_logits": layers[-1]["pred_logits"]} for l in layers]

    main = with_teacher([layer(Q), layer(Q)])
    dn_layers = with_teacher([layer(num_dn), layer(num_dn)])
    plain = {k: main[-1][k] for k in ("pred_logits", "pred_boxes", "pred_corners", "ref_points")}
    arrays = {**plain, "aux_outputs": main[:-1],
              "pre_outputs": {"pred_logits": rng.normal(size=(B, Q, NC)).astype(np.float32),
                              "pred_boxes": _boxes(rng, B, Q)},
              "enc_aux_outputs": [{"pred_logits": rng.normal(size=(B, Q, NC)).astype(np.float32),
                                   "pred_boxes": _boxes(rng, B, Q)}],
              "dn_outputs": dn_layers,
              "dn_pre_outputs": {"pred_logits": rng.normal(size=(B, num_dn, NC)).astype(np.float32),
                                 "pred_boxes": _boxes(rng, B, num_dn)},
              "dn_meta": {k: np.asarray(dn[k]) for k in ("positive", "valid", "gt_index")}}
    statics = {"up": 0.5, "reg_scale": cfg.decoder.reg_scale,
               "enc_meta": {"class_agnostic": False}}
    dn_statics = {"num_dn": num_dn, "num_group": num_group}
    return cfg, t, arrays, statics, dn_statics


def _to_torch_tree(x):
    if isinstance(x, dict):
        return {k: _to_torch_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_torch_tree(v) for v in x]
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("image_valid", [False, True])
def test_criterion_terms_match_jax(image_valid):
    cfg, t, arrays, statics, dn_statics = _criterion_inputs(5)
    if image_valid:
        t = {**t, "image_valid": np.array([True, True, False])}
    jcrit = JCriterion(cfg.criterion, cfg.matcher, num_classes=NC, num_queries=12)

    @jax.jit
    def jax_losses(arrays, targets):
        out = {**arrays, **statics, "dn_meta": {**arrays["dn_meta"], **dn_statics}}
        return jcrit(out, targets)

    want = jax.device_get(jax_losses(arrays, {k: jnp.asarray(v) for k, v in t.items()}))
    tcfg = port_config(cfg)
    tcrit = DFINECriterion(tcfg.criterion, tcfg.matcher, num_classes=NC)
    out = _to_torch_tree(arrays)
    out.update(statics)
    out["dn_meta"].update(dn_statics)
    got = tcrit(out, _torch(t))
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    assert any(k.startswith("loss_ddf_dn") for k in got) and "loss_fgl_pre" not in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), **LOSS_TOL, err_msg=k)


@pytest.mark.parametrize("label_smoothing,image_valid", [(0.0, False), (0.1, True)])
def test_focal_loss_matches_jax(label_smoothing, image_valid):
    """loss_labels_focal, a term the criterion does not dispatch in the
    default configuration, on a fixed match."""
    from custom_d_fine_tpu.train.criterion import loss_labels_focal as jfocal
    from custom_d_fine_tpu_torch.train.criterion import loss_labels_focal as tfocal

    rng = np.random.default_rng(6)
    t = _targets(rng)
    if image_valid:
        t["image_valid"] = np.array([True, False, True])
    logits = rng.normal(size=(B, 9, NC)).astype(np.float32) * 2
    match = {"q": rng.permutation(9)[:G][None].repeat(B, 0).astype(np.int32),
             "g": np.arange(G, dtype=np.int32)[None].repeat(B, 0), "valid": t["valid"]}
    args = dict(num_boxes=3.0, num_classes=NC, alpha=0.75, gamma=2.0,
                label_smoothing=label_smoothing)
    want = jfocal({"pred_logits": jnp.asarray(logits)}, {k: jnp.asarray(v) for k, v in t.items()},
                  {k: jnp.asarray(v) for k, v in match.items()}, **args)
    got = tfocal({"pred_logits": torch.from_numpy(logits)}, _torch(t),
                 {k: torch.from_numpy(v).long() if k != "valid" else torch.from_numpy(v)
                  for k, v in match.items()}, **args)
    np.testing.assert_allclose(got["loss_focal"].item(), float(want["loss_focal"]), **LOSS_TOL)
