"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ../csrc/ becomes one shared library with a plain C interface
(no PyTorch headers, so each nvcc call takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

The libraries go to csrc/_build/<hash of the sources>/ (listed in
.gitignore) at first use; `build_all()` starts one nvcc per source at once.
Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("stem", "stem_tc", "msda", "msda_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return CSRC / "_build" / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build_all(names: List[str] = SOURCES, verbose: bool = False) -> float:
    """Compile every missing library, one nvcc process per source, all
    started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(log.strip())
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of lib<name>.so, built first if it is missing."""
    if name not in _libs:
        lib = _lib_path(name)
        if not lib.exists():
            build_all([name])
        _libs[name] = ctypes.CDLL(str(lib))
    return _libs[name]
