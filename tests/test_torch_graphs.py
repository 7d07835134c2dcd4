"""train/graphs.py on the CPU: when the training step's CUDA graphs engage
(never on the CPU, in eval mode, under no_grad, with several processes, or
during a capture, at either site: the front and the loss terms; a front unit
with a hook inside runs eagerly, a hook on a unit does not stop it), what a
key holds, each site's cap on keys and room rule, and that a step that does
not engage leaves the model as it found it; and the whole mechanism on an
emulated card (tests/torch_emulated_card.py) against eager steps, exactly.
tests/test_torch_criterion_graph.py holds the loss terms' own tests;
tests/test_torch_cuda.py holds the real graphs against eager steps on the
card."""

import pytest
import torch

from custom_d_fine_tpu_torch.train import graphs

from torch_emulated_card import (ON_CARD, batches, cases, config,  # noqa: F401  (fixtures)
                                 emulated_card)
from torch_threads import few_threads  # noqa: F401  (autouse)

SITES = ("front", "loss")


@pytest.fixture(scope="module")
def model(cases):  # noqa: F811
    return cases["detect"].model


@pytest.fixture
def card(monkeypatch):
    """The checks after the device's, as on a card with no capture under way."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)


def _counters(keys):
    return keys.replays, keys.captures, keys.eager


def test_units_are_the_stem_each_stage_and_the_encoder(model):
    got = graphs.units(model)
    assert got == [model.backbone.stem, *model.backbone.stages, model.encoder]
    assert len(got) == 6


def test_a_cpu_step_never_engages(model):
    assert graphs.eager_reason(model, torch.zeros(1, 3, 32, 32)) == "not on the card"


def test_a_training_step_on_the_card_engages(model, card):
    assert graphs.eager_reason(model, ON_CARD) is None


@pytest.mark.parametrize("site,case,reason", [
    ("front", "eval", "eval mode"), ("front", "no_grad", "grad disabled"),
    ("front", "world", "several processes"), ("front", "capturing", "a capture is under way"),
    ("loss", "cpu", "not on the card"), ("loss", "eval", "eval mode"),
    ("loss", "no_grad", "grad disabled"), ("loss", "world", "several processes"),
    ("loss", "capturing", "a capture is under way")])
def test_what_keeps_a_step_eager(cases, monkeypatch, site, case, reason):  # noqa: F811
    """The site runs eagerly: the front sets no unit's forward and counts
    nothing, the terms count one eager unit and equal the criterion's;
    neither keeps a key."""
    c = cases["detect"]
    if site == "loss":
        x, outputs, targets = c.step_inputs()
    on = x if case == "cpu" else ON_CARD
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: case == "capturing")
    if case == "world":  # the other process's counts are zeros
        monkeypatch.setattr(graphs.dist, "world", lambda: (2, 0))
        monkeypatch.setattr(torch.distributed, "all_reduce", lambda t: None)
    step = graphs.StepGraphs(c.criterion)
    keys = getattr(step, site)
    try:
        c.model.train(case != "eval")
        with torch.set_grad_enabled(case != "no_grad"):
            assert graphs.eager_reason(c.model, on) == reason
            if site == "front":
                with step.engaged(c.model, on) as counts:
                    assert all("forward" not in u.__dict__ for u in graphs.units(c.model))
            else:
                got, counts = step.loss_terms(c.model, on, outputs, targets)
    finally:
        c.model.train()
    eager = int(site == "loss")
    assert counts == {"graph_units": 0, "eager_units": eager, "captures": 0} and not keys.chains
    assert _counters(keys) == (0, 0, eager)
    if site == "loss":
        want = c.criterion(outputs, targets)
        assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("where", ["forward", "forward_pre", "full_backward",
                                   "full_backward_pre"])
def test_a_hook_inside_a_unit_keeps_it_eager(model, where):
    stage = model.backbone.stages[1]
    inner = stage.blocks[0].layers[0].conv
    register = getattr(inner, f"register_{where}_hook")
    assert not graphs.hooked_inside(stage)
    handle = register(lambda *a: None)
    try:
        assert graphs.hooked_inside(stage)
        assert not graphs.hooked_inside(model.backbone.stages[0])
    finally:
        handle.remove()
    assert not graphs.hooked_inside(stage)


def test_a_hook_on_a_unit_keeps_it_graphed(model):
    stage = model.backbone.stages[1]
    handles = [stage.register_forward_hook(lambda *a: None),
               stage.register_forward_pre_hook(lambda *a: None)]
    try:
        assert not graphs.hooked_inside(stage)
    finally:
        for h in handles:
            h.remove()


def test_a_global_module_hook_keeps_every_unit_eager(model):
    handle = torch.nn.modules.module.register_module_forward_hook(lambda *a: None)
    try:
        assert all(graphs.hooked_inside(u) for u in graphs.units(model))
    finally:
        handle.remove()
    assert not any(graphs.hooked_inside(u) for u in graphs.units(model))


def _key(tensors, *rest):
    return lambda: graphs.graph_key(tensors, *rest)


def _front_keys(cases):  # noqa: F811
    """The stem input's shape, dtype and strides and the units a hook keeps
    eager; not its values."""
    x = torch.zeros(2, 3, 64, 64)
    return _key([x], ()), [(_key([x], ()), _key([torch.ones(2, 3, 64, 64)], ()))], [
        _key([torch.zeros(2, 3, 64, 96)], ()), _key([torch.zeros(4, 3, 64, 64)], ()),
        _key([x.double()], ()), _key([x.contiguous(memory_format=torch.channels_last)], ()),
        _key([x], (2,))]


def _terms_key(c, **kw):
    _, outputs, targets = c.step_inputs(**kw)
    skeleton, tensors = graphs.flatten((outputs, targets, *c.criterion.match(outputs, targets)))
    return _key(tensors, skeleton)


def _loss_keys(cases):  # noqa: F811
    """The batch, the GT count, the mask size and the class-agnostic flag;
    not the images, boxes, labels, masks or counts (other seeds), and the
    mask size only with the mask head."""
    seg, det = cases["segment"], cases["detect"]
    det_key = _terms_key(det)
    return _terms_key(seg), [(_terms_key(seg), _terms_key(seg, seed=1)),
                             (det_key, _terms_key(det, seed=1)),
                             (det_key, _terms_key(det, img=192))], [
        _terms_key(seg, B=3), _terms_key(seg, G=8), _terms_key(seg, img=192), det_key,
        _terms_key(cases["agnostic"])]


@pytest.mark.parametrize("site", SITES)
def test_what_a_key_holds(cases, site):  # noqa: F811
    """Each site's key follows what its graphs read and the autocast state,
    and nothing else a step can vary."""
    base, equal, others = (_front_keys if site == "front" else _loss_keys)(cases)
    keys = [base()] + [k() for k in others]
    for dtype in (torch.bfloat16, torch.float16):
        with torch.autocast("cpu", dtype=dtype):
            keys.append(base())
    assert all(a() == b() for a, b in equal)
    assert len(set(keys)) == len(keys)


def _kept(keys, key):
    chain = keys.chain(key)
    assert chain is not None
    keys.finish(key, chain)
    return chain


@pytest.mark.parametrize("site", SITES)
def test_the_cap_on_keys(monkeypatch, site):
    """A site keeps at most MAX_KEYS keys, its own: kept keys still replay
    past the cap, and the other site's keys are not counted."""
    monkeypatch.setattr(graphs, "MAX_KEYS", 3)
    step = graphs.StepGraphs(None)
    keys, other = getattr(step, site), step.loss if site == "front" else step.front
    chains = [_kept(keys, ("key", i)) for i in range(3)]
    assert len({id(c) for c in chains}) == 3
    assert keys.chain(("key", 3)) is None  # past the cap: eager
    assert [keys.chain(("key", i)) for i in range(3)] == chains  # kept keys still replay
    assert len(keys.chains) == 3
    assert _kept(other, ("key", 3)) is not None and len(other.chains) == 1


@pytest.mark.parametrize("site", SITES)
def test_a_new_key_needs_room_for_the_largest_capture(monkeypatch, site):
    """A site captures a key only while the card has room for what its own
    largest key's capture took; kept keys replay whatever the room."""
    room = [10 * 2**30]
    monkeypatch.setattr(graphs, "_room", lambda: room[0])
    step = graphs.StepGraphs(None)
    keys, other = getattr(step, site), step.loss if site == "front" else step.front
    first = _kept(keys, ("key", 0))  # the first key: nothing measured yet
    first.need = 8 * 2**30
    _kept(keys, ("key", 1)).need = 12 * 2**30  # 10 GiB of room for 8
    assert keys.chain(("key", 2)) is None  # 10 GiB of room for 12
    assert other.chain(("key", 2)) is not None  # the other site has measured nothing
    room[0] = 12 * 2**30
    assert keys.chain(("key", 2)) is not None
    room[0] = 0
    assert keys.chain(("key", 0)) is first


def test_a_step_that_does_not_engage_leaves_the_model_as_it_was(model):
    """On the CPU `engaged` counts nothing, sets no unit's forward, and the
    model's forward is the eager one."""
    step = graphs.StepGraphs(None)
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        before = model.backbone(x)
        with step.engaged(model, x) as counts:
            assert all("forward" not in u.__dict__ for u in graphs.units(model))
            after = model.backbone(x)
    assert counts == {"graph_units": 0, "eager_units": 0, "captures": 0}
    assert _counters(step.front) == (0, 0, 0) and not step.front.chains
    for a, b in zip(after, before):
        torch.testing.assert_close(a, b)


def test_an_engaged_step_restores_the_units_forwards(model, card, monkeypatch):
    """A step that engages but keeps no key (the cap at 0) runs every unit
    eagerly through the replaced forwards, counts them, and restores each
    unit's own forward afterwards, an instance attribute included."""
    monkeypatch.setattr(graphs, "MAX_KEYS", 0)
    monkeypatch.setattr(graphs, "eager_reason", lambda m, x: None)
    stem = model.backbone.stem
    own = stem.forward
    stem.forward = own  # an instance attribute the step must put back
    step = graphs.StepGraphs(None)
    x = torch.rand(1, 3, 64, 64)
    try:
        with torch.no_grad():
            want = model.encoder(model.backbone(x))
            with step.engaged(model, x) as counts:
                assert all("forward" in u.__dict__ for u in graphs.units(model))
                got = model.encoder(model.backbone(x))
        assert counts == {"graph_units": 0, "eager_units": 6, "captures": 0}
        assert _counters(step.front) == (0, 0, 6)
        assert stem.__dict__["forward"] is own
        assert all("forward" not in u.__dict__ for u in graphs.units(model)[1:])
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b)
    finally:
        del stem.forward


def test_graphed_steps_equal_eager_steps_on_an_emulated_card(emulated_card,  # noqa: F811
                                                             monkeypatch):
    """The whole mechanism on an emulated card: 3 training steps of
    tiny_config at 160^2, f32, with the front and the criterion's loss terms
    captured in step 1 and replayed after, equal exactly 3 eager steps from
    the same state, batches and draws: every loss term, grad_norm, gradient,
    BN buffer, parameter and EMA entry. A hook on stages[1] sees the
    replayed output, the same static tensor each step; a hook inside
    stages[1] runs that unit eagerly under a new key while the loss terms
    replay theirs; each site's counters say so."""
    import copy

    from custom_d_fine_tpu_torch.train.train_step import build_training, make_train_step

    cfg = config("detect")
    step, state = build_training(cfg, 4, device="cpu", bf16=False, seed=0)
    eager_step = make_train_step(step.graphs.criterion)
    eager = copy.deepcopy(state)
    gen, eager_gen = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    front, loss = step.graphs.front, step.graphs.loss
    seen = []
    handle = state.model.backbone.stages[1].register_forward_hook(
        lambda m, a, out: seen.append(out))
    data = batches(cfg, 4)
    for i, b in enumerate(data[:3]):
        n, nl = _counters(front), _counters(loss)
        state, got = step(state, b, gen)
        assert tuple(a - c for a, c in zip(_counters(front), n)) == (6, 6 if i == 0 else 0, 0)
        assert tuple(a - c for a, c in zip(_counters(loss), nl)) == (1, int(i == 0), 0)
        monkeypatch.setattr(graphs, "MAX_KEYS", 0)
        eager, want = eager_step(eager, b, eager_gen)
        assert _counters(eager_step.graphs.loss) == (0, 0, i + 1)
        monkeypatch.setattr(graphs, "MAX_KEYS", 5)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        for (k, p), q in zip(state.model.named_parameters(), eager.model.parameters()):
            assert torch.equal(p.grad, q.grad) and torch.equal(p, q), (i, k)
        for x, y in zip(state.model.buffers(), eager.model.buffers()):
            assert torch.equal(x, y)
        for k in eager.ema:
            assert torch.equal(state.ema[k], eager.ema[k]), (i, k)
    handle.remove()
    (chain,) = front.chains.values()
    assert all(o is not None and o.data_ptr() == chain.units[2].outputs[0].data_ptr()
               for o in seen) and len(seen) == 3

    inner = state.model.backbone.stages[1].blocks[0].register_forward_hook(lambda *a: None)
    n, nl = _counters(front), _counters(loss)
    state, got = step(state, data[3], gen)
    inner.remove()
    assert tuple(a - c for a, c in zip(_counters(front), n)) == (5, 5, 1)
    assert tuple(a - c for a, c in zip(_counters(loss), nl)) == (1, 0, 0)
    assert len(loss.chains) == 1
    assert len(front.chains) == 2 and 2 not in list(front.chains.values())[1].units
