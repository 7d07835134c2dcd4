"""Shared by the port's deploy tests: the same weights on both sides.

`port_config` turns a JAX package ModelConfig (helpers.tiny_config, or a
registry size) into the port's; `port_weights` draws the port's seeded
init with every conv kernel scaled by sqrt(6) (kaiming-uniform instead of
torch's default bound: at the default scale a random model's query scores
tie to ~1e-6, and a comparison would test rounding, not the port);
`flax_variables` carries a port state dict into the JAX package's flax tree
through its own convert_torch_state (jax.eval_shape gives the tree's
structure without compiling the init); `shape_only_build_model` stands in
for the JAX package's build_model where a caller (JaxModel, the JAX
Trainer) loads or replaces the weights anyway: the same flax module, a tree
of zeros, no init compile."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from custom_d_fine_tpu.models.dfine import DFINE as JDFINE
from custom_d_fine_tpu.utils.torch_convert import convert_torch_state
from custom_d_fine_tpu_torch.configs import registry as treg
from custom_d_fine_tpu_torch.models.dfine import build_model as tbuild


def port_config(jcfg):
    def conv(dc, cls):
        return cls(**{f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)})

    return treg.ModelConfig(name=jcfg.name, backbone=conv(jcfg.backbone, treg.BackboneConfig),
                            encoder=conv(jcfg.encoder, treg.EncoderConfig),
                            decoder=conv(jcfg.decoder, treg.DecoderConfig),
                            max_gt=jcfg.max_gt, dn_max_gt=jcfg.dn_max_gt)


def port_weights(tcfg, num_classes, seed=0):
    tm = tbuild(tcfg, num_classes=num_classes, seed=seed)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(np.sqrt(6.0))
    return tm.state_dict()


_ZEROS = {}


def _zeros(model, jcfg, img):
    """The flax variable tree of `model`'s init, as zeros (jax.eval_shape),
    kept per (config, classes, canvas): the tree does not depend on the
    compute dtype or the MSDA implementation, and its callers do not write
    into it."""
    key = (repr(jcfg), model.num_classes, tuple(img))
    if key not in _ZEROS:
        _ZEROS[key] = _zeros_uncached(model, jcfg, img)
    return _ZEROS[key]


def _zeros_uncached(model, jcfg, img):
    G = jcfg.max_gt
    dummy = {"labels": jnp.zeros((1, G), jnp.int32), "boxes": jnp.full((1, G, 4), 0.5),
             "valid": jnp.zeros((1, G), bool)}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1)},
        jnp.zeros((1, *img, 3)), targets=dummy, train=True))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def flax_variables(jcfg, sd, img, num_classes, dtype=None):
    """(flax DFINE, {"params", "batch_stats"}) holding the port's weights."""
    model = JDFINE(cfg=jcfg, num_classes=num_classes, dtype=dtype)
    zeros = _zeros(model, jcfg, img)
    params, stats, _ = convert_torch_state({k: v.numpy() for k, v in sd.items()},
                                           zeros["params"], zeros["batch_stats"], strict=True)
    return model, {"params": params, "batch_stats": stats}


def shape_only_build_model(cfg, num_classes, img_size, rng=None, train_batch=2,
                           msda_impl="xla", stem_impl="conv", dtype=None):
    """custom_d_fine_tpu.models.dfine.build_model's signature and module,
    with a tree of zeros in place of the compiled init."""
    model = JDFINE(cfg=cfg, num_classes=num_classes, msda_impl=msda_impl,
                   stem_impl=stem_impl, dtype=dtype)
    return model, _zeros(model, cfg, img_size)
