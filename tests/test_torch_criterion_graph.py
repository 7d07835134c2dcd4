"""The criterion split into its match and its loss terms, and the terms'
CUDA graphs (train/criterion.py, train/graphs.py), on the CPU, on the
training outputs of tests/helpers.py:tiny_config (160^2, batch 2, f32,
masks at 20^2):
  - `match` then `terms` equal the criterion as it was before the split
    (`_unsplit`, kept here to hold the split to it), bitwise, losses and
    their gradients in the decoder's outputs, for detect, segment and the
    class-agnostic encoder set;
  - the class-agnostic flag alone changes the terms' key;
  - the denoising matches' query indices, now made on the device, equal the
    numpy ones they replace;
  - the terms' graphs on an emulated card (tests/torch_emulated_card.py)
    against the eager terms over three calls on other outputs and targets,
    bitwise, with the counters and the cap on keys;
  - the `train.loss` span's counts in profiled training steps on the
    emulated card, and the share benchmark/metrics/loss.graph_share.train.py
    reads from them.
tests/test_torch_graphs.py holds what the terms share with the front (what
keeps them eager, the key, the cap and the room rule);
tests/test_torch_cuda.py holds the real graphs against the eager terms on
the card."""

import numpy as np
import pytest
import torch

from custom_d_fine_tpu_torch.parallel.dist import global_sum
from custom_d_fine_tpu_torch.train import graphs
from custom_d_fine_tpu_torch.train.criterion import DFINECriterion, _ddf_counts, loss_masks
from custom_d_fine_tpu_torch.train.matcher import match_all_sets

from torch_emulated_card import (CASES, NC, batches, cases, config,  # noqa: F401  (fixtures)
                                 emulated_card)
from torch_threads import few_threads  # noqa: F401  (autouse)


def _dn_match_numpy(dn_meta, targets):
    """The denoising matches as the criterion made them before, the query
    indices in numpy."""
    positive = dn_meta["positive"]
    B, num_dn = positive.shape
    num_group = dn_meta["num_group"]
    Gd = num_dn // (2 * num_group)
    q_idx = torch.from_numpy(np.concatenate(
        [np.arange(Gd) + g * 2 * Gd for g in range(num_group)])).to(positive.device)
    valid = positive[:, q_idx]
    if "image_valid" in targets:
        valid = valid & targets["image_valid"][:, None]
    return {"q": q_idx[None].expand(B, -1), "g": dn_meta["gt_index"].long().repeat(1, num_group),
            "valid": valid}


def _unsplit(crit, outputs, targets):
    """DFINECriterion.__call__ before the split, unchanged but for `self`."""
    wd = crit.cfg.weight_dict
    losses = {}

    def add(ldict, suffix=""):
        for k, val in ldict.items():
            if k in wd:
                losses[k + suffix] = val * wd[k]

    aux_sets = list(outputs.get("aux_outputs", []))
    enc_sets = list(outputs["enc_aux_outputs"])
    sets = [outputs] + aux_sets + [outputs["pre_outputs"]] + enc_sets
    assign, go_g, go_valid = match_all_sets(sets, targets, crit.mcfg)
    B, G = targets["labels"].shape
    Q = outputs["pred_logits"].shape[1]
    dev = go_g.device
    g_base = torch.arange(G, device=dev)[None].expand(B, G)

    def to_match(a):
        return {"q": a, "g": g_base, "valid": (a >= 0) & targets["valid"]}

    n_aux = len(aux_sets)
    matches = [to_match(assign[i]) for i in range(1 + n_aux)]
    match_go = {"q": torch.arange(Q, device=dev)[None].expand(B, Q), "g": go_g,
                "valid": go_valid}
    has_dn = "dn_outputs" in outputs and outputs.get("dn_meta") is not None
    if has_dn:
        match_dn = _dn_match_numpy(outputs["dn_meta"], targets)
        dn_positive = outputs["dn_meta"]["positive"]
        if "image_valid" in targets:
            dn_positive = dn_positive & targets["image_valid"][:, None]
    masks = ("masks" in crit.cfg.losses and outputs.get("pred_masks") is not None
             and targets.get("masks") is not None)
    counts = {"boxes": targets["valid"].sum().float()[None],
              "go": go_valid.sum().float()[None], "ddf": _ddf_counts(match_go, targets, Q)}
    if has_dn:
        counts["dn"] = dn_positive.sum().float()[None]
        counts["ddf_dn"] = _ddf_counts(match_dn, targets, dn_positive.shape[1])
    if masks:
        counts["mask"] = torch.stack([m["valid"].sum().float() for m in matches])
        if has_dn:
            counts["mask_dn"] = match_dn["valid"].sum().float()[None]
    total = global_sum(torch.cat(list(counts.values())))
    counts = dict(zip(counts, total.split([len(c) for c in counts.values()])))
    num_boxes, num_boxes_go = torch.cat([counts["boxes"], counts["go"]]).clamp(min=1.0)
    n_mask = counts["mask"].clamp(min=1.0) if masks else [None] * len(matches)
    extra = {"up": outputs["up"], "reg_scale": outputs["reg_scale"]}
    local = [None, None, False, counts["ddf"]]
    crit._terms(outputs, targets, matches[0], match_go, num_boxes, num_boxes_go, "", add, local,
                n_mask[0])
    for i, aux in enumerate(aux_sets):
        crit._terms({**aux, **extra}, targets, matches[1 + i], match_go, num_boxes,
                    num_boxes_go, f"_aux_{i}", add, local, n_mask[1 + i])
    crit._terms(outputs["pre_outputs"], targets, to_match(assign[1 + n_aux]), match_go,
                num_boxes, num_boxes_go, "_pre", add)
    enc_targets, enc_nc = targets, None
    if outputs.get("enc_meta", {}).get("class_agnostic", False):
        enc_targets, enc_nc = {**targets, "labels": torch.zeros_like(targets["labels"])}, 1
    for i, enc in enumerate(enc_sets):
        crit._terms(enc, enc_targets, to_match(assign[2 + n_aux + i]), match_go, num_boxes,
                    num_boxes_go, f"_enc_{i}", add, num_classes=enc_nc)
    if has_dn:
        n_dn = counts["dn"][0].clamp(min=1.0)
        n_mask_dn = counts["mask_dn"][0].clamp(min=1.0) if masks else None
        local_dn = [None, local[1], True, counts["ddf_dn"]]
        for i, dn_out in enumerate(outputs["dn_outputs"]):
            crit._terms({**dn_out, **extra}, targets, match_dn, match_dn, n_dn, n_dn,
                        f"_dn_{i}", add, local_dn, n_mask_dn)
        if masks and outputs.get("dn_pred_masks") is not None:
            add(loss_masks({"pred_masks": outputs["dn_pred_masks"]}, targets, match_dn,
                           n_mask_dn), "_dn_final")
        if "dn_pre_outputs" in outputs:
            crit._terms(outputs["dn_pre_outputs"], targets, match_dn, match_dn, n_dn, n_dn,
                        "_dn_pre", add)
    return {k: torch.nan_to_num(v, nan=0.0) for k, v in losses.items()}


def _differentiable(outputs):
    """The decoder's output tensors that take a gradient, each once."""
    return [t for t in graphs.flatten(outputs)[1] if t.requires_grad]


def _grads(losses, inputs):
    total = torch.stack(list(losses.values())).sum()
    return torch.autograd.grad(total, inputs, allow_unused=True, retain_graph=True)


def _assert_same(got, want, got_grads, want_grads):
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for i, (a, b) in enumerate(zip(got_grads, want_grads)):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), i


@pytest.mark.parametrize("case", CASES)
def test_match_then_terms_equal_the_criterion_before_the_split(cases, case):
    c = cases[case]
    _, outputs, targets = c.step_inputs(image_valid=case == "segment")
    want = _unsplit(c.criterion, outputs, targets)
    got = c.criterion.terms(outputs, targets, *c.criterion.match(outputs, targets))
    inputs = _differentiable(outputs)
    assert "loss_vfl_enc_0" in want and ("loss_mask_dice_dn_final" in want) == (case == "segment")
    _assert_same(got, want, _grads(got, inputs), _grads(want, inputs))
    assert all(g is not None for g in _grads(got, [outputs["pred_logits"]]))


def test_the_agnostic_key_differs_by_its_flag_alone(cases):
    """The class-agnostic flag is a Python value of the key: flipped on the
    same tensors, the key changes."""
    c = cases["agnostic"]
    _, outputs, targets = c.step_inputs()
    args = (outputs, targets, *c.criterion.match(outputs, targets))
    flipped = ({**outputs, "enc_meta": {"class_agnostic": False}},) + args[1:]
    (s1, t1), (s2, t2) = (graphs.flatten(a) for a in (args, flipped))
    assert graphs.graph_key(t1, s1) != graphs.graph_key(t2, s2)


@pytest.mark.parametrize("num_dn,num_group,image_valid", [(20, 1, False), (60, 3, True),
                                                          (40, 4, False)])
def test_dn_match_indices_made_on_the_device_equal_the_numpy_ones(num_dn, num_group,
                                                                 image_valid):
    rng = np.random.default_rng(num_dn)
    B = 3
    dn_meta = {"positive": torch.from_numpy(rng.uniform(size=(B, num_dn)) < 0.5),
               "gt_index": torch.from_numpy(rng.integers(0, 5, (B, num_dn // (2 * num_group)))),
               "num_group": num_group}
    targets = {"image_valid": torch.tensor([True, False, True])} if image_valid else {}
    got = DFINECriterion._dn_match(None, dn_meta, targets)
    want = _dn_match_numpy(dn_meta, targets)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", ["detect", "segment"])
def test_graphed_terms_equal_eager_terms_on_an_emulated_card(cases, emulated_card, monkeypatch,
                                                            case):
    """Three calls on other outputs and targets (a stale static input would
    show): the first captures the key and replays it, the next two replay;
    losses and the gradients in the decoder's outputs equal the eager
    terms' bitwise. A new batch size is a new key; past MAX_KEYS it runs
    eagerly."""
    c = cases[case]
    step = graphs.StepGraphs(c.criterion)
    keys = step.loss
    for i in range(3):
        x, outputs, targets = c.step_inputs(seed=10 + i)
        got, counts = step.loss_terms(c.model, x, outputs, targets)
        assert counts == {"graph_units": 1, "eager_units": 0, "captures": int(i == 0)}
        assert (keys.replays, keys.captures, keys.eager) == (i + 1, 1, 0)
        want = c.criterion(outputs, targets)
        inputs = _differentiable(outputs)
        _assert_same(got, want, _grads(got, inputs), _grads(want, inputs))
    assert len(keys.chains) == 1 and not step.front.chains
    monkeypatch.setattr(graphs, "MAX_KEYS", 1)
    x, outputs, targets = c.step_inputs(B=3)
    got, counts = step.loss_terms(c.model, x, outputs, targets)
    assert counts == {"graph_units": 0, "eager_units": 1, "captures": 0} and len(keys.chains) == 1
    monkeypatch.setattr(graphs, "MAX_KEYS", 5)
    got, counts = step.loss_terms(c.model, x, outputs, targets)
    assert counts == {"graph_units": 1, "eager_units": 0, "captures": 1} and len(keys.chains) == 2
    assert (keys.replays, keys.captures, keys.eager) == (4, 2, 1)
    want = c.criterion(outputs, targets)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_the_loss_span_counts_and_the_share_they_give(emulated_card, monkeypatch):
    """Three profiled training steps on the emulated card: the first
    captures the loss terms' key and replays it, the second replays it, the
    third runs eagerly (as on the CPU); the reader gives 2 of 3."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import spans as bench_spans
    from benchmark.harness import Profile, load_reader
    from custom_d_fine_tpu_torch.train.train_step import build_training
    from custom_d_fine_tpu_torch.utils.profiling import clear_spans, spans

    cfg = config("detect")
    step, state = build_training(cfg, NC, device="cpu", bf16=False, seed=0)
    gen = torch.Generator().manual_seed(0)
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for i, b in enumerate(batches(cfg, 3)):
            if i == 2:
                monkeypatch.setattr(graphs, "eager_reason", lambda m, x: "not on the card")
            state, _ = step(state, b, gen)
    recorded = spans()
    clear_spans()
    assert [s.counts for s in recorded if s.name == "train.loss"] == [
        {"graph_units": 1, "eager_units": 0, "captures": 1},
        {"graph_units": 1, "eager_units": 0, "captures": 0},
        {"graph_units": 0, "eager_units": 1, "captures": 0}]
    lo = min(s.start_ns for s in recorded)
    hi = max(s.end_ns for s in recorded)
    monkeypatch.setattr(bench_spans, "program_spans", lambda: recorded)
    read = load_reader("loss.graph_share.train")
    window = Profile(window_s=1.0, device=[("k", lo, hi - lo)], units=3)
    assert read({"profile": window}) == pytest.approx(200.0 / 3)
    assert read({"profile": Profile(window_s=1.0)}) is None
