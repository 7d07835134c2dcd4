"""The import check: nothing the benchmark runs loads JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port either."""

import subprocess
import sys

from benchmark.harness import FORBIDDEN, ROOT, forbidden_modules

PROBE = "import sys, json; {imports}; print(json.dumps(sorted(sys.modules)))"


def _modules(imports: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    return __import__("json").loads(out.stdout.strip().splitlines()[-1])


def test_names_are_compared_whole():
    assert forbidden_modules(["custom_d_fine_tpu_torch.ops", "jaxtyping", "flax_x"]) == []
    assert forbidden_modules(["custom_d_fine_tpu.models", "jax._src", "optax"]) == \
        ["custom_d_fine_tpu", "jax", "optax"]


def test_the_run_and_its_program_load_nothing_forbidden():
    mods = _modules("import benchmark.run, benchmark.control, benchmark.runners.train, "
                    "benchmark.faults; "
                    "import custom_d_fine_tpu_torch.train.train_step, "
                    "custom_d_fine_tpu_torch.configs")
    assert "custom_d_fine_tpu_torch" in {m.split(".")[0] for m in mods}
    assert forbidden_modules(mods) == []


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules("import pkgutil, importlib, benchmark.reference.dfine as d; "
                    "[importlib.import_module(m.name) for m in "
                    "pkgutil.walk_packages(d.__path__, d.__name__ + '.')]")
    for name in ("train.train_step", "models.mask", "train.criterion", "train.matcher"):
        assert f"benchmark.reference.dfine.{name}" in mods, name
    assert forbidden_modules(mods, extra=("custom_d_fine_tpu_torch",)) == []


def test_control_with_a_config_and_a_traffic_file_loads_nothing_forbidden(tmp_path):
    """control.py's --config/--traffic: the cell is made from the two files,
    and the control (the reference in the program's place) is built and
    steps once on the CPU at D-FINE-n, without loading JAX, the JAX package
    or the port."""
    import json

    conf = dict(json.loads((ROOT / "benchmark/configs/dfine-m.json").read_text()),
                task="segment", model_name="n")
    mix = dict(json.loads((ROOT / "benchmark/traffic/train.json").read_text()), masks=True,
               batch=1, img=320, pool=1, bf16=False)
    (tmp_path / "seg-n.json").write_text(json.dumps(conf))
    (tmp_path / "train-masks.json").write_text(json.dumps(mix))
    mods = _modules(
        "import torch; from benchmark import control as c; "
        f"args = c.parse(['--config', '{tmp_path / 'seg-n.json'}', '--traffic', "
        f"'{tmp_path / 'train-masks.json'}', '--mode', 'control', '--seeds', '1']); "
        "cell, limits = c.cell_of(args); assert cell.name == 'seg-n.train-masks' and not limits; "
        "run = c.TrainControl(cell, 1, 'cpu'); run.precision = 'fp8'; "
        "from benchmark.generate import train_pool; "
        "step, state = run.build(); "
        "state, m = step(state, train_pool(cell.traffic, 1, 80, 'cpu', run.mask_size)[0], "
        "torch.Generator().manual_seed(1)); assert 'loss_mask_bce' in m")
    assert "benchmark.reference.dfine.models.mask" in mods
    assert forbidden_modules(mods, extra=("custom_d_fine_tpu_torch",)) == []


def test_control_without_a_card_prints_no_readings(tmp_path):
    out = subprocess.run([sys.executable, "-m", "benchmark.control", "--config",
                          "benchmark/configs/dfine-m.json", "--traffic",
                          "benchmark/traffic/train.json", "--seeds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_the_reference_sources_import_only_inside_the_copy():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                top = s.split()[1].split(".")[0]
                assert top not in (*FORBIDDEN, "custom_d_fine_tpu_torch", "benchmark"), (path, s)


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "dfine-m.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
