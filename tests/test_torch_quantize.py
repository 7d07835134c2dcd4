"""The port's int8 weight quantization (custom_d_fine_tpu_torch/deploy/
quantize.py) and its int8 serving graph against the JAX package's
deploy/quantize.py on the same weights:
  - quantize_leaf on conv-, linear- and depthwise-shaped weights: int8
    values and scales bit-equal (per output channel: flax's last axis,
    torch's axis 0; np.round and torch.round both round half to even);
  - the set of quantized names maps one-to-one onto JAX's quantize_params
    paths through the weight bridge (utils/weights.flax_to_torch);
  - quantize_with_accuracy_control on a state-dict version of JAX's toy case
    (tests/test_quantize.py:65) reverts the same tensor with the same report;
  - the int8 serving forward on the CPU against a JAX reference built from
    the package's public functions only: quantize_params(params, skip=<the
    stem's kernels>) -> make_quantized_apply -> topk_detections, which is
    the TPU graph's semantics (the stem on its f32 weights). Held at the
    serving tolerance (1e-4), as tests/test_torch_serving.py holds f32.
The models are helpers.tiny_config at 160^2, 4 classes, not deploy-converted
on either side, so both quantize the same f32 values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.deploy import quantize as jq
from custom_d_fine_tpu.ops.postprocess import topk_detections
from custom_d_fine_tpu_torch.deploy import quantize as tq
from custom_d_fine_tpu_torch.deploy.serving import make_serving_forward
from custom_d_fine_tpu_torch.models.dfine import build_model as tbuild
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch

from helpers import tiny_config
from torch_jax_models import flax_variables, port_config, port_weights
from torch_threads import few_threads  # noqa: F401  (autouse)

IMG = (160, 160)
NC = 4
TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_config()
    tcfg = port_config(jcfg)
    sd = port_weights(tcfg, NC)
    jmodel, variables = flax_variables(jcfg, sd, IMG, NC)
    tmodel = tbuild(tcfg, NC)
    tmodel.load_state_dict(sd)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("flax_shape,to_torch", [
    ((3, 3, 16, 32), (3, 2, 0, 1)),   # conv HWIO -> OIHW
    ((64, 48), (1, 0)),               # Dense [in, out] -> Linear [out, in]
    ((5, 5, 1, 24), (3, 2, 0, 1)),    # depthwise conv
])
def test_quantize_leaf_bit_equal(flax_shape, to_torch):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=flax_shape) * rng.uniform(0.01, 3, flax_shape[-1])).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel: scale 1
    w[..., 5] = w[..., 5].round(1) * 0.5  # values on halves of the grid
    q, s = jq.quantize_leaf(w)
    tq_, ts = tq.quantize_leaf(torch.from_numpy(w.transpose(to_torch).copy()))
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), q.transpose(to_torch))
    np.testing.assert_array_equal(ts.numpy(), s)
    assert float(ts[3]) == 1.0
    deq = tq.dequantize_leaf(tq_, ts).numpy()
    np.testing.assert_array_equal(deq, (q.astype(np.float32) * s).transpose(to_torch))


def test_quantized_names_match_jax_through_the_bridge(tiny):
    jmodel, variables, tmodel = tiny
    _, jpaths = jq.quantize_params(variables["params"])
    jset = set(jpaths)
    # mark JAX's quantized leaves with ones and carry the marks over the bridge
    marks = jax.tree_util.tree_map_with_path(
        lambda p, v: np.full(v.shape, "/".join(k.key for k in p) in jset, np.float32),
        variables["params"])
    sd = flax_to_torch(marks, jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"]))
    marked = {k for k, v in sd.items() if v.numel() and bool((v == 1).all())}
    names = tq.quantizable_names(tmodel)
    assert set(names) == marked
    # each packed in_proj_weight stands for JAX's three q/k/v kernels
    n_packed = sum(k.endswith("in_proj_weight") for k in names)
    assert n_packed > 0 and len(jpaths) == len(names) + 2 * n_packed


def test_accuracy_control_reverts_the_same_tensor():
    """JAX's toy case as a state dict: two kernels (Linear weights, [out,
    in]) and a bias; the metric drops while the large kernel `a` is int8."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(8, 8)).astype(np.float32) * 100
    b = rng.normal(size=(8, 8)).astype(np.float32)
    c = rng.normal(size=(8,)).astype(np.float32)
    jparams = {"a": {"kernel": a}, "b": {"kernel": b}, "c": {"bias": c}}
    jq_state, jrep = jq.quantize_with_accuracy_control(
        jparams, lambda p: 0.5 if "kernel@q" in p["a"] else 0.9, max_drop=0.02)
    state = {"a.weight": torch.from_numpy(a.T.copy()), "b.weight": torch.from_numpy(b.T.copy()),
             "c.bias": torch.from_numpy(c)}
    tq_state, trep = tq.quantize_with_accuracy_control(
        state, ["a.weight", "b.weight"], lambda s: 0.5 if "a.weight@q" in s else 0.9,
        max_drop=0.02)
    for k in ("baseline_metric", "quantized_metric", "drop", "n_quantized", "n_reverted"):
        assert trep[k] == jrep[k], k
    assert trep["reverted"] == [p.replace("/kernel", ".weight") for p in jrep["reverted"]]
    assert "a.weight" in tq_state and "a.weight@q" not in tq_state
    np.testing.assert_array_equal(tq_state["b.weight@q"].numpy(), jq_state["b"]["kernel@q"].T)
    np.testing.assert_array_equal(tq_state["b.weight@scale"].numpy(),
                                  jq_state["b"]["kernel@scale"])


def test_int8_serving_matches_jax_quantized_apply(tiny):
    jmodel, variables, tmodel = tiny
    x_u8 = np.random.default_rng(0).integers(0, 256, (2, *IMG, 3)).astype(np.uint8)
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    stem = {"/".join(k.key for k in p) for p, _ in flat}
    stem = {p for p in stem if p.startswith("backbone/stem/") and p.endswith("kernel")}
    assert len(stem) == 5
    qparams, quantized = jq.quantize_params(variables["params"], skip=stem)
    apply = jq.make_quantized_apply(jmodel, variables["batch_stats"])
    fn = jax.jit(lambda q, x: topk_detections(
        *(lambda o: (o["pred_logits"], o["pred_boxes"]))(apply(q, x.astype(jnp.float32) / 255.0)),
        300, IMG))
    jdet = jax.device_get(fn(qparams, jnp.asarray(x_u8)))

    fwd = make_serving_forward(tmodel, IMG, quantize_int8=True)
    qw = fwd.module.qweights
    assert len(qw.names) == len(quantized) - 2 * sum(n.endswith("in_proj_weight")
                                                     for n in qw.names)
    assert all(getattr(qw, f"q{i}").dtype == torch.int8 for i in range(len(qw.names)))
    assert not any(n.startswith("backbone.stem.") for n in qw.names)
    # the f32 weights left the graph's copy of the model; the caller's keeps them
    assert all(dict(fwd.module.model.named_parameters()).get(n) is None for n in qw.names)
    assert dict(tmodel.named_parameters())[qw.names[0]].dtype == torch.float32
    tdet = {k: v.numpy() for k, v in fwd(torch.from_numpy(x_u8)).items()}

    np.testing.assert_allclose(tdet["scores"], jdet["scores"], atol=TOL)
    for b in range(2):
        keep = np.ones(tdet["scores"].shape[1], bool)
        for s in (tdet["scores"][b], jdet["scores"][b]):
            d = np.abs(np.diff(s)) > TOL
            keep[:-1] &= d
            keep[1:] &= d
        assert keep.sum() >= 5
        np.testing.assert_array_equal(tdet["labels"][b][keep], jdet["labels"][b][keep])
        np.testing.assert_allclose(tdet["boxes"][b][keep], jdet["boxes"][b][keep],
                                   atol=TOL * max(IMG))


def test_dequantize_inverts_quantize_on_the_model(tiny):
    _, _, tmodel = tiny
    sd = dict(tmodel.state_dict())
    names = tq.quantizable_names(tmodel)
    qstate, quantized = tq.quantize_params(sd, names, skip={names[0]})
    assert quantized == [n for n in sd if n in set(names[1:])]
    back = tq.dequantize_params(qstate)
    assert back.keys() == sd.keys()
    assert back[names[0]] is sd[names[0]]
    for n in names[1:]:
        q, s = qstate[n + "@q"], qstate[n + "@scale"]
        torch.testing.assert_close(back[n], q.float() * s.reshape(-1, *[1] * (q.ndim - 1)),
                                   rtol=0, atol=0)
        assert (back[n] - sd[n]).abs().max() <= s.max() / 2 * (1 + 1e-6)
