"""BENCHMARK.json against its contract, and every name resolving to its files."""

import json
import re

import pytest

from benchmark.runners.common import config_dict, model_config
from benchmark.harness import HERE, ROOT, find_cell, load_json, load_reader
from benchmark.reference.dfine.configs import get_model_config as ref_config

SPEC = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["benchmark"] and len(SPEC["command"]) <= 32
    assert 1 <= len(SPEC["workloads"]) <= 24 and 1 <= len(SPEC["configs"]) <= 24
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)


def test_names_units_and_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)
    assert "setup_s" in names


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = find_cell(cell)
    assert (HERE / "runners" / f"{c.traffic['kind']}.py").is_file()
    assert (HERE / "limits" / f"{cell}.json").is_file()
    assert "setup_s" in [m["name"] for m in c.end_to_end] and len(c.end_to_end) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(load_reader(m["name"]))
        assert m["moves"] in [e["name"] for e in c.end_to_end]


def registry_faults(f) -> list:
    """Where a configuration file's `model` is not its registry entry, in
    either registry: for task detect the entry itself; for task segment the
    entry with the mask head on and "masks" among the criterion's losses
    (common.model_config; the port's get_model_config(..., enable_mask_head=
    True) with with_mask_losses). Any other task is a fault."""
    import dataclasses

    from custom_d_fine_tpu_torch.configs import get_model_config as port_config
    from custom_d_fine_tpu_torch.train.criterion import with_mask_losses

    if f["task"] not in ("detect", "segment"):
        return [f"task {f['task']!r}"]
    seg = f["task"] == "segment"
    ref = ref_config(f["model_name"])
    if seg:
        ref = ref.replace(decoder=dataclasses.replace(ref.decoder, enable_mask_head=True),
                          criterion=dataclasses.replace(
                              ref.criterion, losses=tuple(ref.criterion.losses) + ("masks",)))
    port = port_config(f["model_name"], enable_mask_head=seg)
    if seg:
        port = port.replace(criterion=with_mask_losses(port.criterion))
    return [name for name, want in (("reference registry", ref), ("port registry", port))
            if f["model"] != config_dict(want)]


@pytest.mark.parametrize("conf", [c["name"] for c in SPEC["configs"]])
def test_config_file_is_the_registry_entry(conf):
    c = {x["name"]: x for x in SPEC["configs"]}[conf]
    f = load_json(ROOT / c["file"])
    assert registry_faults(f) == []
    assert f["model"] == config_dict(model_config(f))
    assert f["reduced"] == c["reduced"] == []


def _changed(model, path, value):
    out = json.loads(json.dumps(model))
    d = out
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = value
    return out


DETECT_M = load_json(ROOT / "benchmark" / "configs" / "dfine-m.json")
SEGMENT_M = dict(DETECT_M, task="segment",
                 model=config_dict(model_config(dict(DETECT_M, task="segment"))))


@pytest.mark.parametrize("f,faults", [
    (DETECT_M, []),
    (SEGMENT_M, []),
    (dict(DETECT_M, model=_changed(DETECT_M["model"], ("decoder", "num_layers"), 3)),
     ["reference registry", "port registry"]),
    (dict(DETECT_M, model=_changed(DETECT_M["model"], ("decoder", "enable_mask_head"), True)),
     ["reference registry", "port registry"]),
    (dict(DETECT_M, task="segment"), ["reference registry", "port registry"]),
    (dict(SEGMENT_M, model=_changed(SEGMENT_M["model"], ("decoder", "mask_dim"), 128)),
     ["reference registry", "port registry"]),
    (dict(SEGMENT_M, model=_changed(SEGMENT_M["model"], ("criterion", "losses"),
                                    ["vfl", "boxes", "local"])),
     ["reference registry", "port registry"]),
    (dict(DETECT_M, task="pose"), ["task 'pose'"]),
], ids=["detect", "segment", "detect-depth", "detect-with-head", "segment-detect-model",
        "segment-width", "segment-without-mask-losses", "other-task"])
def test_the_registry_rule_fails_a_file_that_departs(f, faults):
    assert registry_faults(f) == faults


@pytest.mark.parametrize("size", ["n", "s", "m", "l", "x"])
def test_both_registries_hold_the_size_alike(size):
    """The reference's registry holds every size of the port's, field by
    field, so that the harness can run any of them."""
    from custom_d_fine_tpu_torch.configs import get_model_config as port_config
    from custom_d_fine_tpu_torch.configs.registry import MODELS as PORT_MODELS
    from benchmark.reference.dfine.configs.registry import MODELS

    assert list(MODELS) == list(PORT_MODELS)
    assert config_dict(ref_config(size)) == config_dict(port_config(size))


def test_both_hgnetv2_tables_are_equal():
    from custom_d_fine_tpu_torch.models.hgnetv2 import ARCH_CONFIGS as PORT
    from benchmark.reference.dfine.models.hgnetv2 import ARCH_CONFIGS

    assert list(ARCH_CONFIGS) == [f"B{i}" for i in range(7)]
    assert ARCH_CONFIGS == PORT
