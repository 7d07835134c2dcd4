"""custom_d_fine_tpu_torch stands alone: every module imports in a process
where jax and flax cannot be imported, and no custom_d_fine_tpu module gets
loaded; chip_smoke.py imports neither. Entry points (build_serving,
build_training, the Trainer, TorchModel and the CLIs) default to the card."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax"):
    sys.modules[name] = None  # any import of them raises ImportError
import custom_d_fine_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "custom_d_fine_tpu" or m.startswith("custom_d_fine_tpu."))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 40  # modules of the port


def test_no_source_names_jax_or_the_jax_package():
    files = sorted((ROOT / "custom_d_fine_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "custom_d_fine_tpu"), (f, m)


def test_build_serving_defaults_to_the_card():
    from custom_d_fine_tpu_torch.deploy.serving import build_serving, resolve_device

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serving()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_build_training_defaults_to_the_card():
    from custom_d_fine_tpu_torch.train.train_step import build_training

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_training()
    with pytest.raises(ValueError, match="bf16"):  # the CPU copy is the f32 reference
        build_training(device="cpu")


def test_trainer_defaults_to_the_card(tmp_path):
    """The Trainer takes train.device (cuda unless a run asks for cpu), and
    refuses bfloat16 on the CPU; the CLI passes the config through."""
    from custom_d_fine_tpu_torch.cli.train import main
    from custom_d_fine_tpu_torch.train.trainer import Trainer
    from custom_d_fine_tpu_torch.utils.config import load_config

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = load_config(overrides=[f"train.path_to_save={tmp_path}"])
    assert cfg["train"]["device"] == "cuda" and cfg["train"]["dtype"] == "bfloat16"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    with pytest.raises(ValueError, match="bfloat16"):
        Trainer(load_config(overrides=[f"train.path_to_save={tmp_path}", "train.device=cpu"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([f"train.path_to_save={tmp_path}"])


def test_runtime_and_its_clis_default_to_the_card(tmp_path):
    """TorchModel takes device (cuda unless the caller passes cpu); the
    serving CLIs pass train.device (cuda by default) through."""
    from custom_d_fine_tpu_torch.cli import bench, export, infer, test_batching
    from custom_d_fine_tpu_torch.infer.model import TorchModel

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchModel(None, "n", 4, img_size=(256, 256))
    assert TorchModel(None, "n", 4, img_size=(256, 256), device="cpu",
                      smoke_test=False).device.type == "cpu"
    (tmp_path / "val.csv").write_text("a.jpg\n")  # bench reads the split first
    for cli in (infer, bench, export, test_batching):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([f"train.path_to_save={tmp_path}", f"train.root={tmp_path}",
                      f"train.data_path={tmp_path}"])
