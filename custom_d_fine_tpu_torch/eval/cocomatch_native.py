"""ctypes binding for the C++ COCOeval matcher (eval/cocomatch.cpp).

The port's copy of custom_d_fine_tpu/eval/cocomatch_native.py, with its own
copy of native/cocomatch.cpp beside it. Host-side native counterpart of the
reference's faster-coco-eval C extension (reference
src/dl/validator.py:52-67): one call performs the full greedy matching scan
for one class — all images x area ranges x IoU thresholds — leaving no
per-detection or per-range Python work.

At first use the host C++ compiler builds the source into
eval/_build/<hash of the source and flags>/libcocomatch.so (listed in
.gitignore). If no compiler is found or the build fails, coco_map.py takes
its numpy matcher, which gives the same answers (tests/test_torch_eval.py);
`available()` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import logger

_SRC = Path(__file__).resolve().parent / "cocomatch.cpp"
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_lib = None  # None = not attempted, False = build/load failed, CDLL = loaded

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode() + _SRC.read_bytes())
    return _SRC.parent / "_build" / h.hexdigest()[:16] / "libcocomatch.so"


def _build(lib: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise OSError("no C++ compiler found")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp), str(_SRC)], check=True,
                   capture_output=True)
    os.replace(tmp, lib)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is False:  # cached build/load failure: don't rebuild per call
        return None
    if _lib is not None:
        return _lib
    lib_file = _lib_path()
    try:
        if not lib_file.exists():
            _build(lib_file)
        lib = ctypes.CDLL(str(lib_file))
    except (OSError, subprocess.CalledProcessError) as e:
        logger.warning(f"native cocomatch unavailable ({e}); mAP uses the numpy matcher")
        _lib = False
        return None
    lib.coco_match_class.restype = ctypes.c_int
    lib.coco_match_class.argtypes = [
        _f32p, _f32p, _u8p, _f32p, _i32p, ctypes.c_int32,
        _f64p, ctypes.c_int32, _f64p, ctypes.c_int32,
        _u8p, _u8p, _i32p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def match_class(
    ious: List[np.ndarray],      # per image [D_k, G_k] f32 (crowd IoA folded)
    g_areas: List[np.ndarray],   # per image [G_k] f32
    g_crowd: List[np.ndarray],   # per image [G_k] bool
    d_areas: List[np.ndarray],   # per image [D_k] f32
    thresholds: np.ndarray,      # [T] f64
    ranges: Sequence[Tuple[float, float]],  # [(lo, hi)] inclusive
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Match one class across K images / R ranges / T thresholds.

    Returns (tp [R, T, D_total] bool, dt_ig [R, T, D_total] bool,
    n_gt [R] int32), detections concatenated in image order — the same
    layout coco_map builds by concatenating _match_image results.
    """
    lib = _load()
    assert lib is not None, "native cocomatch unavailable"
    K = len(ious)
    dg = np.zeros((K, 2), np.int32)
    for k, m in enumerate(ious):
        dg[k] = m.shape
    d_total = int(dg[:, 0].sum())

    iou_cat = (np.concatenate([np.asarray(m).reshape(-1) for m in ious])
               if K else np.zeros((0,), np.float32))
    iou_cat = np.ascontiguousarray(iou_cat, np.float32)
    ga_cat = np.ascontiguousarray(
        np.concatenate(g_areas) if K else np.zeros((0,)), np.float32)
    gc_cat = np.ascontiguousarray(
        np.concatenate(g_crowd) if K else np.zeros((0,)), np.uint8)
    da_cat = np.ascontiguousarray(
        np.concatenate(d_areas) if K else np.zeros((0,)), np.float32)
    thr = np.ascontiguousarray(thresholds, np.float64)
    rng = np.ascontiguousarray(np.asarray(ranges, np.float64).reshape(-1, 2))
    T, R = len(thr), len(rng)

    tp = np.zeros((R, T, d_total), np.uint8)
    ig = np.zeros((R, T, d_total), np.uint8)
    ngt = np.zeros((R,), np.int32)
    lib.coco_match_class(
        iou_cat.ctypes.data_as(_f32p), ga_cat.ctypes.data_as(_f32p),
        gc_cat.ctypes.data_as(_u8p), da_cat.ctypes.data_as(_f32p),
        np.ascontiguousarray(dg).ctypes.data_as(_i32p), K,
        thr.ctypes.data_as(_f64p), T, rng.ctypes.data_as(_f64p), R,
        tp.ctypes.data_as(_u8p), ig.ctypes.data_as(_u8p),
        ngt.ctypes.data_as(_i32p),
    )
    return tp.astype(bool), ig.astype(bool), ngt
