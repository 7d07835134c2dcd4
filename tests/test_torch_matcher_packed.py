"""The port's matcher over each image's valid GT columns only
(train/matcher.py, ops/hungarian.py) against the JAX package's host solve
over the padded costs, on a tiny model's output sets (final, aux, pre and
encoder; tests/helpers.py:tiny_config, batch 3, 10 GT slots):
  - match_all_sets gives the same assign, go_g and go_valid, bitwise, as the
    JAX package's host_solve + host_go_union on the padded [S, B, Q, G]
    costs of the port's own matching_cost (padding at 1e6), for GT counts
    with 0, 1 and max_gt, with and without ties (costs rounded to 0.25);
  - with the mask head, the packed mask costs equal the valid columns of
    mask_matching_cost at rtol 1e-5, and the match is optimal under the
    padded box + mask costs (a near tie may flip between the two GEMM
    widths, so each assignment's cost is compared, at rtol 1e-5);
  - the matcher calls its module's host_solve once a match with two
    positional arguments, and host_solve calls its module's
    linear_sum_assignment on contiguous [Q, n] blocks, queries as rows.
"""

import numpy as np
import pytest
import torch

from custom_d_fine_tpu.ops import hungarian as jhung
from custom_d_fine_tpu_torch.ops import hungarian
from custom_d_fine_tpu_torch.train import matcher

from torch_emulated_card import NC, TinyCase
from torch_threads import few_threads  # noqa: F401  (autouse)

B = 3
N_VALID = [(0, 1, 10), (10, 10, 10), (0, 0, 0), (1, 4, 2)]


def _sets(outputs):
    """The output sets in the order DFINECriterion.match gives them."""
    return ([outputs] + list(outputs.get("aux_outputs", [])) + [outputs["pre_outputs"]]
            + list(outputs["enc_aux_outputs"]))


def _targets(n_valid, G, hm=0, seed=0):
    rng = np.random.default_rng(seed)
    valid = np.arange(G)[None] < np.asarray(n_valid)[:, None]
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, G, 2)), rng.uniform(0.1, 0.2, (B, G, 2))],
                           -1)
    t = {"labels": torch.from_numpy(rng.integers(0, NC, (B, G))),
         "boxes": torch.from_numpy(boxes.astype(np.float32)), "valid": torch.from_numpy(valid)}
    if hm:
        m = (rng.uniform(size=(B, G, hm, hm)) < 0.3) & valid[..., None, None]
        t["masks"] = torch.from_numpy(m.astype(np.uint8))
    return t


def _padded_costs(sets, targets, cfg):
    """[S, B, Q, G] on the host as the matcher built them before packing: box
    (+ mask) costs of every set, padded GT columns at 1e6."""
    costs = []
    for o in sets:
        c = matcher.matching_cost(o["pred_logits"], o["pred_boxes"], targets["labels"],
                                  targets["boxes"], cfg)
        if o.get("pred_masks") is not None and targets.get("masks") is not None:
            c = c + matcher.mask_matching_cost(o["pred_masks"], targets["masks"], cfg)
        costs.append(c)
    return torch.where(targets["valid"][None, :, None, :], torch.stack(costs), 1e6).numpy()


@pytest.fixture(scope="module")
def tiny():
    """Output sets of one training forward of the tiny detector and segmenter."""
    out = {}
    with torch.no_grad():
        for case in ("detect", "segment"):
            c = TinyCase(case)
            _, outputs, _ = c.step_inputs(B=B)
            out[case] = (c.cfg, _sets(outputs))
    return out


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("n_valid", N_VALID)
def test_match_all_sets_equals_the_padded_jax_solve(tiny, monkeypatch, n_valid, tied):
    cfg, sets = tiny["detect"]
    if tied:
        cost = matcher.matching_cost
        monkeypatch.setattr(matcher, "matching_cost",
                            lambda *a: torch.round(cost(*a) * 4) / 4)
    targets = _targets(n_valid, cfg.max_gt)
    costs = _padded_costs(sets, targets, cfg.matcher)
    n = np.asarray(n_valid)
    want = jhung.host_solve(costs, n)
    want_go = jhung.host_go_union(want, n, costs.shape[2])
    if tied and any(n_valid):  # the rounding leaves ties for the solver to break
        blocks = [costs[s, b, :, :k] for s in range(len(sets)) for b, k in enumerate(n_valid)]
        assert any(np.unique(c).size < c.size for c in blocks if c.size)
    assign, go_g, go_valid = matcher.match_all_sets(sets, targets, cfg.matcher)
    assert assign.dtype == torch.int64 and assign.shape == (len(sets), B, cfg.max_gt)
    np.testing.assert_array_equal(assign.numpy(), want)
    np.testing.assert_array_equal(go_g.numpy(), want_go[0])
    np.testing.assert_array_equal(go_valid.numpy(), want_go[1])


def _mask_sets(tiny):
    cfg, sets = tiny["segment"]
    return cfg, [o for o in sets if o.get("pred_masks") is not None]


@pytest.mark.parametrize("n_valid", N_VALID)
def test_packed_mask_costs_are_the_valid_columns(tiny, n_valid):
    cfg, sets = _mask_sets(tiny)
    hm = sets[0]["pred_masks"].shape[-1]
    masks = _targets(n_valid, cfg.max_gt, hm)["masks"]
    for o in sets:
        got = matcher.packed_mask_cost(o["pred_masks"], masks, n_valid, cfg.matcher)
        full = matcher.mask_matching_cost(o["pred_masks"], masks, cfg.matcher)
        want = [full[b, :, :k].flatten() for b, k in enumerate(n_valid) if k]
        want = torch.cat(want) if want else full.new_zeros(0)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def _total(costs, assign, n_valid):
    return np.array([[costs[s, b, assign[s, b, :k], np.arange(k)].astype(np.float64).sum()
                      for b, k in enumerate(n_valid)] for s in range(len(costs))])


@pytest.mark.parametrize("n_valid", N_VALID)
def test_a_segment_match_is_optimal_under_the_padded_costs(tiny, n_valid):
    cfg, sets = tiny["segment"]
    hm = _mask_sets(tiny)[1][0]["pred_masks"].shape[-1]
    targets = _targets(n_valid, cfg.max_gt, hm)
    costs = _padded_costs(sets, targets, cfg.matcher)
    want = jhung.host_solve(costs, np.asarray(n_valid))
    assign = matcher.match_all_sets(sets, targets, cfg.matcher)[0].numpy()
    for s in range(len(sets)):
        for b, k in enumerate(n_valid):
            a = assign[s, b]
            assert (a[k:] == -1).all() and (a[:k] >= 0).all() and len(set(a[:k])) == k
    np.testing.assert_allclose(_total(costs, assign, n_valid), _total(costs, want, n_valid),
                               rtol=1e-5)


def test_one_host_solve_a_match_on_query_row_blocks(tiny, monkeypatch):
    """What the benchmark's replay and its wrong-matching fault rely on."""
    cfg, sets = tiny["detect"]
    n_valid = (2, 0, 5)
    calls, blocks = [], []
    solve, lsa = matcher.host_solve, hungarian.linear_sum_assignment

    def recorded_solve(*args, **kwargs):
        calls.append((len(args), kwargs))
        return solve(*args, **kwargs)

    def recorded_lsa(cost):
        blocks.append((cost.shape, cost.flags.c_contiguous))
        return lsa(cost)

    monkeypatch.setattr(matcher, "host_solve", recorded_solve)
    monkeypatch.setattr(hungarian, "linear_sum_assignment", recorded_lsa)
    assign = matcher.match_all_sets(sets, _targets(n_valid, cfg.max_gt), cfg.matcher)[0]
    Q = cfg.decoder.num_queries
    assert calls == [(2, {})] and assign.shape == (len(sets), B, cfg.max_gt)
    assert blocks == [((Q, k), True) for k in n_valid if k for _ in sets]
