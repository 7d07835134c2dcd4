"""The port's bfloat16 serving variant (deploy/serving.py: the model under
torch.autocast(bfloat16), stem and top-K in f32) on the CPU:
  - against the JAX package's bfloat16 graph (build_model(...,
    dtype=bfloat16) through make_serving_forward) on the same weights and
    batch. flax's dtype=bfloat16 and torch's autocast round at different
    places, so the two are compared in detection space only, by the set-based
    check of deploy/export.py:export_and_verify (sorted scores atol 2e-2; at
    most 5% of the JAX graph's top-50 without a same-label, IoU >= 0.5
    counterpart within 0.02 in score);
  - its torch.export artifact (autocast kept inside the graph) against the
    live bf16 forward at 1e-5.
helpers.tiny_config at 160^2, 4 classes, the port's seeded weights (conv
kernels x sqrt(6)), deploy-converted on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.deploy.reparam import convert_to_deploy as jdeploy
from custom_d_fine_tpu.deploy.serving import make_serving_forward as jserving
from custom_d_fine_tpu_torch.deploy.export import check_same_detections, export_and_verify
from custom_d_fine_tpu_torch.deploy.reparam import convert_to_deploy
from custom_d_fine_tpu_torch.deploy.serving import make_serving_forward
from custom_d_fine_tpu_torch.models.dfine import build_model as tbuild

from helpers import tiny_config
from torch_jax_models import flax_variables, port_config, port_weights
from torch_threads import few_threads  # noqa: F401  (autouse)

IMG = (160, 160)
NC = 4


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_config()
    tcfg = port_config(jcfg)
    sd = port_weights(tcfg, NC)
    model = tbuild(tcfg, NC)
    model.load_state_dict(sd)
    convert_to_deploy(model)
    return jcfg, sd, model


def test_bf16_serving_matches_jax_bf16_graph(weights):
    jcfg, sd, model = weights
    x_u8 = np.random.default_rng(0).integers(0, 256, (2, *IMG, 3)).astype(np.uint8)
    jmodel, variables = flax_variables(jcfg, sd, IMG, NC, dtype=jnp.bfloat16)
    dmodel, dvars = jdeploy(jmodel, variables)
    fwd = jserving(dmodel, dvars, IMG, use_fused_stem=False, fast_topk=False)
    jdet = jax.device_get(jax.jit(fwd)(jnp.asarray(x_u8)))
    jdet = {k: np.asarray(v, np.float32 if k != "labels" else np.int32) for k, v in jdet.items()}

    tfwd = make_serving_forward(model, IMG, bf16=True)
    tdet = {k: v.numpy() for k, v in tfwd(torch.from_numpy(x_u8)).items()}
    f32 = make_serving_forward(model, IMG)(torch.from_numpy(x_u8))
    f32 = {k: v.numpy() for k, v in f32.items()}
    assert tdet["scores"].dtype == np.float32 and tdet["boxes"].dtype == np.float32
    assert np.abs(tdet["scores"] - f32["scores"]).max() > 1e-5  # bf16 did round
    check_same_detections(tdet, jdet, top_check=50)


def test_bf16_artifact_matches_live(weights, tmp_path):
    _, _, model = weights
    path = export_and_verify(model, IMG, tmp_path / "model_bfloat16.pt2", bf16=True)
    ep = torch.export.load(str(path))
    targets = [str(n.target) for gm in ep.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes]
    assert "wrap_with_autocast" in targets  # the autocast region is inside the graph
    assert targets.count("dfine_port.msda_fwd.default") == len(model.decoder.decoder.layers)
