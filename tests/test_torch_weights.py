"""The port's weight bridge (custom_d_fine_tpu_torch/utils/weights.py) is the
inverse of the JAX package's checkpoint map: the port's state_dict ->
convert_torch_state -> flax_to_torch is the identity, with no unmatched,
missed or mismatched keys, on the key sets of every registry size and of
m with the mask head (the MaskDecoder's lateral.i/bn.i GroupNorms, bn1 and
mask_head.layers.i, which an original `.pth` carries under the same names,
so it loads into the port without conversion)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.configs import get_model_config as jax_config
from custom_d_fine_tpu.models.dfine import DFINE as JaxDFINE
from custom_d_fine_tpu.utils.torch_convert import convert_torch_state
from custom_d_fine_tpu_torch.configs import get_model_config
from custom_d_fine_tpu_torch.models.dfine import DFINE
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch

from torch_threads import few_threads  # noqa: F401  (autouse)


def _flax_shapes(size: str, img: int = 320, enable_mask_head: bool = False):
    """The flax variable tree of build_model's init, as shapes only
    (jax.eval_shape: no compile)."""
    cfg = jax_config(size, enable_mask_head=enable_mask_head)
    model = JaxDFINE(cfg=cfg, num_classes=80)
    G = cfg.max_gt
    targets = {"labels": jnp.zeros((1, G), jnp.int32),
               "boxes": jnp.full((1, G, 4), 0.5, jnp.float32),
               "valid": jnp.zeros((1, G), bool).at[:, 0].set(True)}
    rngs = {"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1)}
    return jax.eval_shape(lambda: model.init(rngs, jnp.zeros((1, img, img, 3)),
                                             targets=targets, train=True))


@pytest.mark.parametrize("size", ["n", "s", "m", "l", "x", "m-segment"])
def test_state_dict_roundtrip_identity(size):
    size, _, task = size.partition("-")
    seg = task == "segment"
    torch.manual_seed(3)  # torch's default init: any distinct values will do
    model = DFINE(get_model_config(size, enable_mask_head=seg), num_classes=80)
    # non-default BN statistics, so that running stats are really carried
    g = np.random.default_rng(0)
    for m in model.modules():
        if hasattr(m, "running_var"):
            m.running_mean.copy_(torch.from_numpy(
                g.normal(size=m.running_mean.shape).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                g.uniform(0.5, 1.5, m.running_var.shape).astype(np.float32)))
    with torch.no_grad():  # and non-default GroupNorm affines
        for m in model.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.copy_(torch.from_numpy(g.uniform(0.5, 1.5, m.weight.shape)
                                                .astype(np.float32)))
                m.bias.copy_(torch.from_numpy(g.normal(size=m.bias.shape).astype(np.float32)))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert seg == any(k.startswith("decoder.mask_decoder.bn.1.") for k in sd)
    shapes = _flax_shapes(size, enable_mask_head=seg)
    params, stats, report = convert_torch_state(sd, shapes["params"], shapes["batch_stats"])
    assert report == {"unmatched": [], "shape_mismatch": [], "missed": []}, report

    back = flax_to_torch(params, stats)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_subtree_prefix_names():
    """A backbone subtree converts with the ConvBNAct `bn` naming; elsewhere
    BN keeps `norm`."""
    p = {"conv": {"kernel": np.ones((3, 3, 2, 4), np.float32)},
         "norm": {"bn": {"scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}}}
    s = {"norm": {"bn": {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}}}
    bb = flax_to_torch(p, s, prefix="backbone/stem/stem1")
    assert set(bb) == {"conv.weight", "bn.weight", "bn.bias", "bn.running_mean",
                       "bn.running_var", "bn.num_batches_tracked"}
    assert bb["conv.weight"].shape == (4, 2, 3, 3)
    enc = flax_to_torch(p, s, prefix="encoder/lateral_convs_0")
    assert "norm.running_var" in enc and "bn.weight" not in enc
