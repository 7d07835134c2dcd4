"""The port's CLIs besides train (custom_d_fine_tpu_torch/cli/*) on the CPU:
  - split_dataset, check_errors.find_errors and infer._pad_box against the
    JAX package's on the same inputs: equal outputs;
  - bench (float32, bfloat16 and int8 rows through TorchModel, the JAX CSV's
    columns), test_batching, check_errors, quantize_int8 (report and the
    saved int8 state dict) and export (the float32 .pt2 artifact, loaded back
    and held against the live forward; the bfloat16 one is
    test_torch_bf16.py's) run end to end through main() on a synthetic YOLO
    set, with train.device=cpu;
  - the demo's handler answers one POST of a JPEG with a JPEG (a stub model).
(infer_folder is held against the JAX CLI in test_torch_runtime.py.) The
model is registry size n at 256^2 (the smallest canvas with 300 anchors),
random weights: the point is the plumbing, not the metrics."""

import csv
import shutil
import threading
from http.server import HTTPServer
from urllib.request import Request, urlopen

import cv2
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.cli import check_errors as jcheck
from custom_d_fine_tpu.cli import infer as jinfer
from custom_d_fine_tpu.cli import split as jsplit
from custom_d_fine_tpu_torch.cli import (bench, check_errors, demo, export, infer, quantize_int8,
                                         split, test_batching)
from custom_d_fine_tpu_torch.configs import get_model_config

from torch_jax_models import port_weights
from torch_threads import few_threads  # noqa: F401  (autouse)


def _raw_dataset(root, n=20, seed=0):
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (120, 160) if i % 2 else (160, 120)
        cv2.imwrite(str(root / "images" / f"a{i}.jpg"),
                    rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
        if i % 4:  # some negatives
            rows = [f"{int(rng.integers(0, 2))} {rng.uniform(0.3, 0.7):.6f} "
                    f"{rng.uniform(0.3, 0.7):.6f} {rng.uniform(0.1, 0.4):.6f} "
                    f"{rng.uniform(0.1, 0.4):.6f}" for _ in range(1 + i % 3)]
            (root / "labels" / f"a{i}.txt").write_text("\n".join(rows) + "\n")
    return root


@pytest.mark.parametrize("kw", [dict(train_split=0.7, val_split=0.2, seed=1),
                                dict(train_split=0.8, val_split=0.2, seed=3,
                                     ignore_negatives=True),
                                dict(train_split=0.5, val_split=0.5, shuffle=False)])
def test_split_matches_jax(tmp_path, kw):
    a = _raw_dataset(tmp_path / "a")
    b = tmp_path / "b"
    shutil.copytree(a, b)
    assert split.split_dataset(a, **kw) == jsplit.split_dataset(b, **kw)
    for name in ("train", "val", "test"):
        assert (a / f"{name}.csv").exists() == (b / f"{name}.csv").exists()
        if (a / f"{name}.csv").exists():
            assert (a / f"{name}.csv").read_text() == (b / f"{name}.csv").read_text()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_errors_matches_jax(seed):
    rng = np.random.default_rng(seed)
    gt_xy = rng.uniform(0, 200, (12, 2))
    gt = {"boxes": np.concatenate([gt_xy, gt_xy + rng.uniform(10, 60, (12, 2))], 1)
          .astype(np.float32), "labels": rng.integers(0, 3, 12)}
    jitter = rng.normal(0, 4, (12, 4)).astype(np.float32)
    extra = rng.uniform(0, 250, (5, 4)).astype(np.float32)
    extra[:, 2:] = extra[:, :2] + 20
    pred = {"boxes": np.concatenate([gt["boxes"] + jitter, extra]),
            "labels": np.concatenate([np.where(rng.uniform(size=12) < 0.8, gt["labels"], 2),
                                      rng.integers(0, 3, 5)])}
    assert check_errors.find_errors(pred, gt, 0.5) == jcheck.find_errors(pred, gt, 0.5)
    empty = {"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros((0,), int)}
    assert check_errors.find_errors(pred, empty, 0.5) == jcheck.find_errors(pred, empty, 0.5)


@pytest.mark.parametrize("box,pw,ph", [((10, 10, 30, 30), 0.1, 0.5), ((10, 10, 30, 30), 5, 5),
                                       ((0, 0, 30, 30), 10, 10), ((80.5, 70.2, 99.9, 99.7),
                                                                  0.05, 0.05)])
def test_pad_box_matches_jax(box, pw, ph):
    assert infer._pad_box(box, pw, ph, 100, 100) == jinfer._pad_box(box, pw, ph, 100, 100)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A YOLO set of 3 train and 2 val JPEGs, and a Trainer-style model.pt
    (random weights of n, 2 classes) that the CLIs take with --weights."""
    root = _raw_dataset(tmp_path_factory.mktemp("ds"), n=6)
    (root / "train.csv").write_text("a1.jpg\na2.jpg\na3.jpg\n")
    (root / "val.csv").write_text("a4.jpg\na5.jpg\n")
    sd = port_weights(get_model_config("n"), 2)
    torch.save({"model": sd, "ema": {"module": sd}}, root / "model.pt")
    return root


def _overrides(dataset, tmp_path, *extra):
    return ["--weights", str(dataset / "model.pt"), f"train.data_path={dataset}",
            f"train.path_to_save={tmp_path}/run",
            f"train.root={tmp_path}", "train.device=cpu", "model_name=n",
            "train.img_size=[256,256]", "train.label_to_name={0: a, 1: b}",
            "train.batch_size=2", "train.num_workers=1", "train.conf_thresh=0.03",
            f"train.bench_img_path={tmp_path}/bench", *extra]


def test_bench_main_writes_the_jax_columns(dataset, tmp_path):
    bench.main(_overrides(dataset, tmp_path))
    rows = list(csv.DictReader(open(tmp_path / "run" / "bench.csv")))
    assert [r["backend"] for r in rows] == ["torch_float32", "torch_bfloat16", "torch_int8"]
    assert list(rows[0]) == ["backend", "f1", "precision", "recall", "iou", "mAP_50",
                             "mAP_50_95", "latency_ms_p50", "latency_ms_mean"]
    assert all(float(r["latency_ms_p50"]) > 0 for r in rows)
    for variant in ("float32", "bfloat16", "int8"):  # the rendered val images
        assert sorted(p.name for p in (tmp_path / "bench" / variant).iterdir()) == [
            "a4.jpg", "a5.jpg"]


def test_test_batching_main(dataset, tmp_path, monkeypatch):
    """The sweep's loop, CSV and table, over batch sizes 1, 2 and 4 (the
    CLI's 8-32 cost seconds of CPU each and add no path)."""
    monkeypatch.setattr(test_batching, "BATCH_SIZES", (1, 2, 4))
    rows = test_batching.main(["--n-images", "2", *_overrides(dataset, tmp_path)])
    assert [r["batch_size"] for r in rows] == [1, 2, 4]
    assert all(r["throughput_img_s"] > 0 for r in rows)
    assert (tmp_path / "run" / "batching.csv").exists()


def test_check_errors_main(dataset, tmp_path):
    check_errors.main(_overrides(dataset, tmp_path))
    out = tmp_path / "output" / "label_errors"
    # a5 has ground truth that random weights miss (a4 is a negative, which
    # shows only where a detection passes the threshold)
    assert "a5.jpg" in [p.name for p in (out / "val").iterdir()]
    assert {p.name for p in (out / "train").iterdir()} >= {"a1.jpg", "a2.jpg", "a3.jpg"}


def test_quantize_int8_and_export_main(dataset, tmp_path):
    """quantize_int8 on the val split (random weights: F1 0 before and after,
    so nothing is reverted) and export of both variants."""
    report = quantize_int8.main(_overrides(dataset, tmp_path))
    saved = torch.load(tmp_path / "run" / "model_int8.pt", weights_only=False)
    assert saved["report"] == report and report["n_reverted"] == 0
    n_q = report["n_quantized"]
    assert sum(k.endswith("@q") for k in saved["model"]) == n_q > 100
    assert all(saved["model"][k].dtype == torch.int8 for k in saved["model"] if k.endswith("@q"))
    export.main(_overrides(dataset, tmp_path, "export.half=false"))
    assert (tmp_path / "run" / "model_float32.pt2").stat().st_size > 10_000_000
    assert not (tmp_path / "run" / "model_bfloat16.pt2").exists()


class _Stub:
    def __call__(self, img):
        h, w = img.shape[:2]
        return [{"boxes": np.array([[2, 2, w // 2, h // 2]], np.float32),
                 "labels": np.array([0], np.int32), "scores": np.array([0.9], np.float32)}]


def test_demo_answers_a_post():
    server = HTTPServer(("localhost", 0), demo.make_handler(_Stub(), {0: "object"}))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        ok, jpg = cv2.imencode(".jpg", np.full((48, 64, 3), 90, np.uint8))
        boundary = "xyzzy"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
                f"filename=\"a.jpg\"\r\nContent-Type: image/jpeg\r\n\r\n").encode() \
            + jpg.tobytes() + f"\r\n--{boundary}--\r\n".encode()
        url = f"http://localhost:{server.server_address[1]}/predict"
        req = Request(url, data=body, method="POST", headers={
            "Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urlopen(req, timeout=30) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/jpeg"
            out = cv2.imdecode(np.frombuffer(r.read(), np.uint8), cv2.IMREAD_COLOR)
        assert out.shape == (48, 64, 3)
        with urlopen(url.replace("/predict", "/"), timeout=30) as r:
            assert b"<form" in r.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
