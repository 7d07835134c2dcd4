"""A detect configuration computes, draws and reads what it did before the
harness took task segment: the `train` mix's pool and D-FINE-m's weights for
two seeds, and the reference's detect forward and training step at
D-FINE-n 320x320, hashed and held to digests recorded from the commit before
(the CPU, one thread). The pool's and the weights' draws hold on any CPU
build. The forward's and the step's digests hold on the build they were
recorded on (RECORDED_BUILD); on another, whose kernels may sum in another
order, those results are held instead to values recorded from the same
commit on that build (VALUES): the norms of the forward's outputs and the
step's losses and gradient norm to rtol 1e-4, as the parity tests hold two
f32 programs that sum in different orders, and the summed norms of the
parameters' and the EMA's change to rtol 1e-3, since AdamW's first step
divides each gradient by its own magnitude and so carries rounding of the
smallest gradients into the update."""

import hashlib

import pytest
import torch

from benchmark.generate import train_pool
from benchmark.harness import HERE, load_json
from benchmark.reference.dfine.models.dfine import DFINE
from benchmark.reference.dfine.train.criterion import DFINECriterion
from benchmark.reference.dfine.train.optim import Optimizer
from benchmark.reference.dfine.train.train_step import RefState, train_step
from benchmark.runners.common import model_config
from benchmark.weights import make_weights

RECORDED = {
    "pool.2147483653": "8ad2fb196996ec08c0c56dc4",
    "weights.m.2147483653": "a6f15aefbc34a9a9dca48e3e",
    "pool.17": "f54ea5bb06b24358a2a66d84",
    "weights.m.17": "ceb1f3dd1c96e34afefb7d63",
    "forward.n": "44d7155129f5bb5133753765",
    "step.n.losses": "f2c8667193983b1d012f1810",
    "step.n.params": "df54e173710873c0040b8f8a",
    "step.n.ema": "6b0f3e19fa3cf9d05f04745e",
}
RECORDED_BUILD = "2.13.0+cpu"
VALUES = {
    "forward": {"pred_boxes": 21.109405122944114, "pred_logits": 1025.7703472452492},
    "step": {"total_loss": 28.021217346191406, "grad_norm": 117.32693481445312,
             "terms": 28.02121540904045, "params": 0.21103820683081637,
             "ema": 73.45584724023355},
}
STEP_RTOL = {"total_loss": 1e-4, "grad_norm": 1e-4, "terms": 1e-4, "params": 1e-3, "ema": 1e-3}
DETECT_N = {"model_name": "n", "task": "detect", "num_classes": 80}


def digest(tensors) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().cpu().contiguous()
        h.update(k.encode())
        h.update(str(t.dtype).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:24]


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 17])
def test_train_pool_and_m_weights_are_the_recorded_ones(seed):
    mix = dict(load_json(HERE / "traffic" / "train.json"), img=64)  # every draw but the pixels
    pool = train_pool(mix, seed, 80, "cpu")
    assert digest({f"{i}.{k}": v for i, b in enumerate(pool) for k, v in b.items()}) == \
        RECORDED[f"pool.{seed}"]
    cfg = model_config({"model_name": "m", "task": "detect"})
    assert digest(make_weights(cfg, 80, seed, torch.device("cpu"))) == RECORDED[f"weights.m.{seed}"]


def _model():
    cfg = model_config(DETECT_N)
    model = DFINE(cfg, num_classes=80)
    model.load_state_dict(make_weights(cfg, 80, 3, torch.device("cpu")))
    return cfg, model


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _close(got: float, want: float, rtol: float) -> bool:
    return abs(got - want) <= rtol * abs(want)


def test_reference_detect_forward_is_the_recorded_one():
    _, model = _model()
    x = torch.rand((2, 3, 320, 320), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model.eval()(x)
    if torch.__version__ == RECORDED_BUILD:
        assert digest(out) == RECORDED["forward.n"]
    else:
        got = {k: _norm(v) for k, v in out.items()}
        assert got.keys() == VALUES["forward"].keys()
        assert all(_close(got[k], v, 1e-4) for k, v in VALUES["forward"].items()), got


def test_reference_detect_step_is_the_recorded_one():
    cfg, model = _model()
    mix = dict(load_json(HERE / "traffic" / "train.json"), batch=2, img=320, pool=1)
    batch = train_pool(mix, 5, 80, "cpu")[0]
    opt = {k: mix[k] for k in ("base_lr", "backbone_lr", "total_steps")}
    model = model.train()
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    ref = RefState(model, Optimizer(model, cfg, **opt),
                   {k: v.clone() for k, v in model.state_dict().items()})
    e0 = {k: v.clone() for k, v in ref.ema.items()}
    m = train_step(ref, DFINECriterion(cfg.criterion, cfg.matcher, 80), batch,
                   torch.Generator().manual_seed(9))
    if torch.__version__ == RECORDED_BUILD:
        assert digest(m) == RECORDED["step.n.losses"]
        assert digest(dict(model.named_parameters())) == RECORDED["step.n.params"]
        assert digest(ref.ema) == RECORDED["step.n.ema"]
        return
    got = {"total_loss": float(m["total_loss"]), "grad_norm": float(m["grad_norm"]),
           "terms": sum(abs(float(v)) for k, v in m.items() if k.startswith("loss_")),
           "params": sum(_norm(v - p0[k]) for k, v in model.named_parameters()),
           "ema": sum(_norm(v.float() - e0[k].float()) for k, v in ref.ema.items()
                      if v.is_floating_point())}
    assert all(_close(got[k], v, STEP_RTOL[k]) for k, v in VALUES["step"].items()), got


def test_the_program_built_from_model_config_is_the_one_built_from_its_name():
    """The runner hands build_training common.model_config's entry, where it
    handed the size's name: for detect the port takes the same step."""
    from custom_d_fine_tpu_torch.train.train_step import build_training

    mix = dict(load_json(HERE / "traffic" / "train.json"), batch=2, img=320, pool=1)
    batch = train_pool(mix, 5, 80, "cpu")[0]
    w = make_weights(model_config(DETECT_N), 80, 3, torch.device("cpu"))
    opt = {k: mix[k] for k in ("base_lr", "backbone_lr", "total_steps")}
    runs = []
    for size in ("n", model_config(DETECT_N)):
        step, state = build_training(size, 80, device="cpu", bf16=False, state_dict=w, **opt)
        _, m = step(state, batch, torch.Generator().manual_seed(9))
        runs.append((digest(m), digest(dict(state.model.named_parameters()))))
    assert runs[0] == runs[1]


def test_segment_weights_add_the_mask_head_to_the_detect_draws():
    """A segment model's leaves outside the mask head are the detect model's
    of the same seed; the mask head's are drawn (U(+-1/sqrt(fan_in)), up_conv
    normal with std sqrt(2 / fan_out)), its GroupNorms at (1, 0)."""
    det = make_weights(model_config(DETECT_N), 80, 11, torch.device("cpu"))
    seg = make_weights(model_config(dict(DETECT_N, task="segment")), 80, 11, torch.device("cpu"))
    head = sorted(set(seg) - set(det))
    assert head and all(k.startswith(("decoder.mask_decoder.", "decoder.mask_head.")) for k in head)
    assert all(torch.equal(det[k], seg[k]) for k in det)
    up = seg["decoder.mask_decoder.up_conv.weight"]
    assert abs(up.std().item() / (2.0 / (up.shape[0] * 9)) ** 0.5 - 1) < 0.05
    lat = seg["decoder.mask_decoder.lateral.0.weight"]
    assert 0.9 < lat.abs().max().item() * lat.shape[1] ** 0.5 <= 1.0
    assert torch.equal(seg["decoder.mask_decoder.bn1.weight"], torch.ones(256))
    assert torch.equal(seg["decoder.mask_decoder.bn1.bias"], torch.zeros(256))
