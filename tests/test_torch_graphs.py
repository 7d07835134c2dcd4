"""train/graphs.py on the CPU: when the training step's CUDA graphs engage
(never on the CPU, in eval mode, under no_grad, with several processes, or
during a capture; a unit with a hook inside runs eagerly, a hook on a unit
does not stop it), what a key holds, the cap on keys, and that a step that
does not engage leaves the model as it found it; and the whole mechanism on
an emulated card (capture records the aten ops, replay reruns them) against
eager steps, exactly. tests/test_torch_cuda.py holds the real graphs
against eager steps on the card."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from custom_d_fine_tpu_torch.models.dfine import build_model
from custom_d_fine_tpu_torch.train import graphs

from helpers import tiny_config
from torch_jax_models import port_config

ON_CARD = SimpleNamespace(is_cuda=True)  # what eager_reason reads of a card tensor


@pytest.fixture(scope="module")
def model():
    return build_model(port_config(tiny_config()), num_classes=4, seed=0).train()


@pytest.fixture
def card(monkeypatch):
    """The checks after the device's, as on a card with no capture under way."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)


def test_units_are_the_stem_each_stage_and_the_encoder(model):
    got = graphs.units(model)
    assert got == [model.backbone.stem, *model.backbone.stages, model.encoder]
    assert len(got) == 6


def test_a_cpu_step_never_engages(model):
    assert graphs.eager_reason(model, torch.zeros(1, 3, 32, 32)) == "not on the card"


def test_a_training_step_on_the_card_engages(model, card):
    assert graphs.eager_reason(model, ON_CARD) is None


@pytest.mark.parametrize("case,reason", [("eval", "eval mode"), ("no_grad", "grad disabled"),
                                         ("world", "several processes"),
                                         ("capturing", "a capture is under way")])
def test_what_keeps_a_step_eager(model, card, monkeypatch, case, reason):
    if case == "world":
        monkeypatch.setattr(graphs.dist, "world", lambda: (2, 0))
    if case == "capturing":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    try:
        model.train(case != "eval")
        with torch.set_grad_enabled(case != "no_grad"):
            assert graphs.eager_reason(model, ON_CARD) == reason
    finally:
        model.train()


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


def test_the_key_is_shape_dtype_strides_autocast_and_eager_units():
    x = torch.zeros(2, 3, 64, 64)
    key = graphs.graph_key(x, ())
    assert graphs.graph_key(torch.ones(2, 3, 64, 64), ()) == key  # values do not matter
    others = [graphs.graph_key(torch.zeros(2, 3, 64, 96), ()),
              graphs.graph_key(torch.zeros(4, 3, 64, 64), ()),
              graphs.graph_key(x.double(), ()),
              graphs.graph_key(x.contiguous(memory_format=torch.channels_last), ()),
              graphs.graph_key(x, (2,))]
    with torch.autocast("cpu", dtype=torch.bfloat16):
        others.append(graphs.graph_key(x, ()))
    with torch.autocast("cpu", dtype=torch.float16):
        others.append(graphs.graph_key(x, ()))
    assert len({key, *others}) == len(others) + 1


def test_the_cap_on_keys(monkeypatch):
    monkeypatch.setattr(graphs, "MAX_KEYS", 3)
    front = graphs.FrontGraphs()
    chains = [front.chain(("key", i)) for i in range(3)]
    assert all(c is not None for c in chains) and len({id(c) for c in chains}) == 3
    assert front.chain(("key", 3)) is None  # past the cap: eager
    assert [front.chain(("key", i)) for i in range(3)] == chains  # kept keys still replay
    assert len(front.chains) == 3


def test_a_step_that_does_not_engage_leaves_the_model_as_it_was(model):
    """On the CPU `engaged` counts nothing, sets no unit's forward, and the
    model's forward is the eager one."""
    front = graphs.FrontGraphs()
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        before = model.backbone(x)
        n = (graphs.replays, graphs.captures, graphs.eager)
        with front.engaged(model, x) as counts:
            assert all("forward" not in u.__dict__ for u in graphs.units(model))
            after = model.backbone(x)
    assert counts == {"graph_units": 0, "eager_units": 0, "captures": 0}
    assert (graphs.replays, graphs.captures, graphs.eager) == n and not front.chains
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
    front = graphs.FrontGraphs()
    x = torch.rand(1, 3, 64, 64)
    try:
        with torch.no_grad():
            want = model.encoder(model.backbone(x))
            with front.engaged(model, x) as counts:
                assert all("forward" in u.__dict__ for u in graphs.units(model))
                got = model.encoder(model.backbone(x))
        assert counts == {"graph_units": 0, "eager_units": 6, "captures": 0}
        assert stem.__dict__["forward"] is own
        assert all("forward" not in u.__dict__ for u in graphs.units(model)[1:])
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b)
    finally:
        del stem.forward


def test_a_new_key_needs_room_for_the_largest_capture(monkeypatch):
    """A key is captured only while the card has room for what the largest
    key's capture step took; kept keys replay whatever the room."""
    room = [10 * 2**30]
    monkeypatch.setattr(graphs, "_room", lambda: room[0])
    front = graphs.FrontGraphs()
    first = front.chain(("key", 0))  # the first key: nothing measured yet
    first.need = 8 * 2**30
    assert front.chain(("key", 1)) is not None  # 10 GiB of room for 8
    front.chains[("key", 1)].need = 12 * 2**30
    assert front.chain(("key", 2)) is None  # 10 GiB of room for 12
    room[0] = 12 * 2**30
    assert front.chain(("key", 2)) is not None
    room[0] = 0
    assert front.chain(("key", 0)) is first


class _Recording(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class _EmulatedGraph:
    """A CUDA graph on the CPU: capture records the aten ops and the tensors
    they produced; replay runs them again below autograd (no version counts)
    and writes each result into the tensor the capture produced, so later ops
    and the caller read it there, as from a graph's static memory."""

    def __init__(self):
        self.ops = []

    def replay(self):
        with torch._C._AutoDispatchBelowADInplaceOrView(), torch.no_grad():
            for func, args, kwargs, out in self.ops:
                for o, n in zip(tree_flatten(out)[0], tree_flatten(func(*args, **kwargs))[0]):
                    if isinstance(o, torch.Tensor) and o.data_ptr() != n.data_ptr():
                        o.data.copy_(n)


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def emulated_card(monkeypatch):
    """torch.cuda's graph and stream calls as graphs.py makes them, on the CPU."""
    @contextlib.contextmanager
    def capture(graph, pool=None):
        with _Recording(graph.ops):
            yield

    for name, value in {"CUDAGraph": _EmulatedGraph, "graph": capture,
                        "graph_pool_handle": lambda: (0, 1), "Stream": _Stream,
                        "stream": lambda s: contextlib.nullcontext(),
                        "current_stream": _Stream}.items():
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(graphs, "eager_reason", lambda m, x: (
        None if m.training and torch.is_grad_enabled() else "eval or no grad"))
    monkeypatch.setattr(graphs, "_room", lambda: 1 << 40)
    monkeypatch.setattr(graphs, "_no_weight_cache", lambda device_type: contextlib.nullcontext())


def _batches(cfg, n, B=2, img=160):
    rng = np.random.default_rng(0)
    G = cfg.max_gt
    out = []
    for _ in range(n):
        valid = np.arange(G)[None] < rng.integers(1, 6, (B, 1))
        boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, G, 2)),
                                rng.uniform(0.1, 0.2, (B, G, 2))], -1)
        out.append({"images": torch.from_numpy(rng.integers(0, 256, (B, img, img, 3),
                                                            dtype=np.uint8)),
                    "labels": torch.from_numpy(rng.integers(0, 4, (B, G))),
                    "boxes": torch.from_numpy(boxes.astype(np.float32)),
                    "valid": torch.from_numpy(valid)})
    return out


def _loss_counters(since=(0, 0, 0)):
    from custom_d_fine_tpu_torch.train import loss_graphs

    now = (loss_graphs.replays, loss_graphs.captures, loss_graphs.eager)
    return tuple(a - b for a, b in zip(now, since))


def test_graphed_steps_equal_eager_steps_on_an_emulated_card(emulated_card, monkeypatch):
    """The whole mechanism on an emulated card (capture records the aten ops,
    replay reruns them into the captured tensors): 3 training steps of
    tiny_config at 160^2, f32, with the front and the criterion's loss terms
    (train/loss_graphs.py) captured in step 1 and replayed after, equal
    exactly 3 eager steps from the same state, batches and draws: every loss
    term, grad_norm, gradient, BN buffer, parameter and EMA entry. A hook on
    stages[1] sees the replayed output, the same static tensor each step; a
    hook inside stages[1] runs that unit eagerly under a new key while the
    loss terms replay theirs; the counters say so."""
    import copy

    from custom_d_fine_tpu_torch.train.train_step import build_training

    cfg = port_config(tiny_config())
    step, state = build_training(cfg, 4, device="cpu", bf16=False, seed=0)
    eager_step, _ = build_training(cfg, 4, device="cpu", bf16=False, seed=0)
    eager = copy.deepcopy(state)
    gen, eager_gen = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    seen = []
    handle = state.model.backbone.stages[1].register_forward_hook(
        lambda m, a, out: seen.append(out))
    batches = _batches(cfg, 4)
    for i, b in enumerate(batches[:3]):
        n = (graphs.replays, graphs.captures, graphs.eager)
        nl = _loss_counters()
        state, got = step(state, b, gen)
        assert (graphs.replays - n[0], graphs.captures - n[1], graphs.eager - n[2]) == \
            (6, 6 if i == 0 else 0, 0)
        assert _loss_counters(nl) == (1, int(i == 0), 0)
        monkeypatch.setattr(graphs, "MAX_KEYS", 0)
        nl = _loss_counters()
        eager, want = eager_step(eager, b, eager_gen)
        assert _loss_counters(nl) == (0, 0, 1)
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
    (chain,) = step.graphs.chains.values()
    assert all(o is not None and o.data_ptr() == chain.units[2].outputs[0].data_ptr()
               for o in seen) and len(seen) == 3

    inner = state.model.backbone.stages[1].blocks[0].register_forward_hook(lambda *a: None)
    n = (graphs.replays, graphs.captures, graphs.eager)
    nl = _loss_counters()
    state, got = step(state, batches[3], gen)
    inner.remove()
    assert (graphs.replays - n[0], graphs.captures - n[1], graphs.eager - n[2]) == (5, 5, 1)
    assert _loss_counters(nl) == (1, 0, 0) and len(step.loss_graphs.keys) == 1
    assert len(step.graphs.chains) == 2 and 2 not in list(step.graphs.chains.values())[1].units
