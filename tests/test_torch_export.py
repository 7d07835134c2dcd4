"""The port's exported artifact (custom_d_fine_tpu_torch/deploy/export.py:
torch.export of the serving graph, saved as a .pt2 file) on the CPU:
  - export_and_verify: the artifact, loaded back, against the live serving
    forward at rtol = atol = 1e-5 (the JAX package's CPU check);
  - the artifact loaded in a fresh process that imports only the port (jax,
    flax and the JAX package cannot be imported there), against the live
    forward at 1e-5, and both against the JAX package's make_serving_forward
    at the serving tolerance (scores atol 1e-4; labels and boxes, pixels at
    1e-4 x the image size, where a score stands more than 1e-4 from its
    neighbours);
  - the exported graph holds the port's custom ops: one stem and one MSDA
    forward per decoder layer (what launches the kernels on the card);
  - torch.library.opcheck passes on each op's CPU implementation.
helpers.tiny_config at 160^2, 4 classes, the port's seeded weights (conv
kernels x sqrt(6)) on both sides, deploy-converted."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.deploy.reparam import convert_to_deploy as jdeploy
from custom_d_fine_tpu.deploy.serving import make_serving_forward as jserving
from custom_d_fine_tpu_torch.deploy.export import export_and_verify
from custom_d_fine_tpu_torch.deploy.reparam import convert_to_deploy
from custom_d_fine_tpu_torch.deploy.serving import make_serving_forward
from custom_d_fine_tpu_torch.models.dfine import build_model as tbuild
from custom_d_fine_tpu_torch.ops.msda import _flat, level_start_index
from custom_d_fine_tpu_torch.ops.stem import WEIGHT_KEYS, fold_stem_weights
from custom_d_fine_tpu_torch.models.hgnetv2 import StemBlock

from helpers import tiny_config
from torch_jax_models import flax_variables, port_config, port_weights
from torch_threads import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
IMG = (160, 160)
NC = 4
TOL = 1e-4

_LOAD = r"""
import sys
for name in ("jax", "jaxlib", "flax"):
    sys.modules[name] = None
import numpy as np, torch
torch.set_num_threads(2)
from custom_d_fine_tpu_torch.deploy.export import load_inference_artifact
fn = load_inference_artifact(sys.argv[1])
with torch.inference_mode():
    out = fn(torch.from_numpy(np.load(sys.argv[2])))
np.savez(sys.argv[3], **{k: v.numpy() for k, v in out.items()})
assert not any(m == "custom_d_fine_tpu" or m.startswith("custom_d_fine_tpu.") for m in sys.modules)
"""


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jcfg = tiny_config()
    tcfg = port_config(jcfg)
    sd = port_weights(tcfg, NC)
    model = tbuild(tcfg, NC)
    model.load_state_dict(sd)
    convert_to_deploy(model)
    path = export_and_verify(model, IMG, tmp_path_factory.mktemp("export") / "model.pt2")
    return jcfg, sd, model, path


def _robust(scores):
    gap = np.full(scores.shape, np.inf)
    d = np.abs(np.diff(scores))
    gap[:-1] = np.minimum(gap[:-1], d)
    gap[1:] = np.minimum(gap[1:], d)
    return gap > TOL


def test_artifact_in_a_fresh_process_matches_live_and_jax(exported, tmp_path):
    jcfg, sd, model, path = exported
    x_u8 = np.random.default_rng(0).integers(0, 256, (1, *IMG, 3)).astype(np.uint8)
    np.save(tmp_path / "x.npy", x_u8)
    r = subprocess.run([sys.executable, "-c", _LOAD, str(path), str(tmp_path / "x.npy"),
                        str(tmp_path / "out.npz")], cwd=ROOT, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode == 0, r.stderr[-4000:]
    art = dict(np.load(tmp_path / "out.npz"))
    live = make_serving_forward(model, IMG)(torch.from_numpy(x_u8))
    live = {k: v.numpy() for k, v in live.items()}
    for k in ("scores", "boxes", "labels"):
        np.testing.assert_allclose(art[k], live[k], rtol=1e-5, atol=1e-5, err_msg=k)

    jmodel, variables = flax_variables(jcfg, sd, IMG, NC)
    dmodel, dvars = jdeploy(jmodel, variables)
    fwd = jserving(dmodel, dvars, IMG, use_fused_stem=False, fast_topk=False)
    jdet = jax.device_get(jax.jit(fwd)(jnp.asarray(x_u8)))
    for got in (art, live):
        np.testing.assert_allclose(got["scores"], jdet["scores"], atol=TOL)
        keep = _robust(got["scores"][0]) & _robust(jdet["scores"][0])
        assert keep.sum() >= 5
        np.testing.assert_array_equal(got["labels"][0][keep], jdet["labels"][0][keep])
        np.testing.assert_allclose(got["boxes"][0][keep], jdet["boxes"][0][keep],
                                   atol=TOL * max(IMG))


def test_exported_graph_keeps_the_kernels(exported):
    _, _, model, path = exported
    ep = torch.export.load(str(path))
    targets = [str(n.target) for gm in ep.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
               if n.op == "call_function"]
    n_layers = len(model.decoder.decoder.layers)
    assert targets.count("dfine_port.stem_fwd.default") == 1
    assert targets.count("dfine_port.msda_fwd.default") == n_layers
    assert not any("grid_sampler" in t for t in targets)
    # f32 weights (and the fast stem's bf16 fragments, unused on the CPU)
    assert {k for k, v in ep.state_dict.items() if v.dtype == torch.bfloat16} == {"stem_wtc"}
    assert {v.dtype for v in ep.state_dict.values()} <= {torch.float32, torch.int64,
                                                          torch.bfloat16}
    assert path.stat().st_size > 4 * sum(p.numel() for p in model.parameters()) * 0.99


def _stem_args(fast):
    g = torch.Generator().manual_seed(0)
    stem = StemBlock(3, 16, 16, use_lab=True).eval()
    with torch.no_grad():
        for m in stem.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    fw = fold_stem_weights(stem)
    x = torch.randint(0, 256, (2, 32, 36, 3), dtype=torch.uint8, generator=g)
    return torch.ops.dfine_port.stem_fwd.default, (x, [fw[k] for k in WEIGHT_KEYS],
                                                    fw["wtc"], fast)


def _msda_args(bwd):
    g = torch.Generator().manual_seed(1)
    shapes, points = [(8, 8), (4, 6)], [2, 3]
    value = torch.randn(2, 88, 2, 8, generator=g).requires_grad_(not bwd)
    loc = (torch.rand(2, 5, 2, 5, 2, generator=g) * 1.2 - 0.1).requires_grad_(not bwd)
    attn = torch.rand(2, 5, 2, 5, generator=g).requires_grad_(not bwd)
    levels = (_flat(shapes), list(level_start_index(shapes)))
    if not bwd:
        return torch.ops.dfine_port.msda_fwd.default, (value, *levels, loc, attn, points)
    grad = torch.randn(2, 5, 16, generator=g)
    return torch.ops.dfine_port.msda_bwd.default, (value, *levels, loc, attn, grad, points)


@pytest.mark.parametrize("case", ["stem_exact", "stem_fast", "msda_fwd", "msda_bwd"])
def test_opcheck(case):
    op, args = {"stem_exact": lambda: _stem_args(False), "stem_fast": lambda: _stem_args(True),
                "msda_fwd": lambda: _msda_args(False), "msda_bwd": lambda: _msda_args(True)}[case]()
    out = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in out.values()), json.dumps(out)
