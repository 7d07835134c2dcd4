"""The port's inference runtime (custom_d_fine_tpu_torch/infer/model.py:
TorchModel) and folder CLI (cli/infer.py:infer_folder) against the JAX
package's (infer/model.py:JaxModel, cli/infer.py) on the CPU.

One .pt checkpoint, written from the port's seeded init of registry size n
(4 classes, conv kernels x sqrt(6)), is loaded by both runtimes through
their own loaders. It holds other weights under "model" than under
{"ema": {"module": ...}}, so both must take the EMA. n at 256^2 is the
smallest canvas the serving test pays for (its 2 levels give 320 anchors for
300 queries). BGR images of two aspect ratios go through keep_ratio on
(letterbox) and off (plain resize), with a per-class conf dict, NMS off and
on (IoU threshold 0.1: a random model's boxes seldom overlap more, and the
test asks that NMS removes some): the detection dicts must be equal in the
original frame, scores at atol
1e-4 and boxes at 1e-4 x the image's larger side, with labels and boxes
compared where a score stands more than 1e-4 from its neighbours (near-ties
may swap). infer_folder on two JPEGs and a 5-frame video must write the same
label files (normalized boxes at 1e-4), visualizations, video and crops."""

import numpy as np
import pytest
import torch
import cv2

from custom_d_fine_tpu.cli.infer import infer_folder as jax_infer_folder
from custom_d_fine_tpu.infer.model import JaxModel
from custom_d_fine_tpu.models import dfine as jdfine
from custom_d_fine_tpu_torch.cli.infer import infer_folder
from custom_d_fine_tpu_torch.configs import get_model_config
from custom_d_fine_tpu_torch.infer.model import TorchModel

from torch_jax_models import port_weights, shape_only_build_model
from torch_threads import few_threads  # noqa: F401  (autouse)

IMG = (256, 256)
NC = 4
TOL = 1e-4
CONF = {0: 0.04, 1: 0.045, 2: 0.0, 3: 0.05}  # unnamed classes would take 0.5


@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    """JaxModel's build_model makes the tree of zeros that its loader fills
    from the checkpoint, without compiling the init (shape_only_build_model)."""
    cfg = get_model_config("n")
    ema = port_weights(cfg, NC, seed=0)
    raw = port_weights(cfg, NC, seed=1)
    path = tmp_path_factory.mktemp("ckpt") / "model.pt"
    torch.save({"model": raw, "ema": {"module": ema}}, path)
    kw = dict(img_size=IMG, conf_thresh=CONF, nms_iou_thresh=0.1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdfine, "build_model", shape_only_build_model)
        jm = JaxModel(str(path), "n", NC, **kw)
    tm = TorchModel(str(path), "n", NC, device="cpu", **kw)
    return jm, tm


def _images():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (200, 300, 3)).astype(np.uint8),
            rng.integers(0, 256, (330, 180, 3)).astype(np.uint8)]


def _robust(scores):
    gap = np.full(scores.shape, np.inf)
    d = np.abs(np.diff(scores))
    gap[:-1] = np.minimum(gap[:-1], d)
    gap[1:] = np.minimum(gap[1:], d)
    return gap > TOL


def _assert_same(got, want, size):
    assert got.keys() == want.keys() == {"labels", "boxes", "scores"}
    assert len(got["scores"]) == len(want["scores"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL)
    keep = _robust(got["scores"]) & _robust(want["scores"])
    np.testing.assert_array_equal(got["labels"][keep], want["labels"][keep])
    np.testing.assert_allclose(got["boxes"][keep], want["boxes"][keep], atol=TOL * size)
    return int(keep.sum())


@pytest.mark.parametrize("keep_ratio", [False, True])
@pytest.mark.parametrize("which", [0, 1])
def test_detections_match_jax_runtime(runtimes, keep_ratio, which):
    jm, tm = runtimes
    img = _images()[which]
    size = max(img.shape[:2])
    n = {}
    for nms in (False, True):
        for rt in (jm, tm):
            rt.keep_ratio, rt.enable_nms = keep_ratio, nms
        got, want = tm(img), jm(img)
        assert len(got) == len(want) == 1
        assert _assert_same(got[0], want[0], size) >= 5
        n[nms] = len(got[0]["scores"])
        b = got[0]["boxes"]
        assert len(b) and (b >= 0).all()
        assert (b[:, [0, 2]] <= img.shape[1] + 1e-3).all()
        assert (b[:, [1, 3]] <= img.shape[0] + 1e-3).all()
        assert got[0]["labels"].dtype == np.int32
        for c, thr in CONF.items():  # the per-class thresholds applied
            assert (got[0]["scores"][got[0]["labels"] == c] >= thr).all()
    assert 0 < n[True] < n[False]  # NMS suppressed some, kept some
    assert set(tm.timings) == {"preprocess_ms", "forward_ms", "postprocess_ms"}


def test_infer_folder_writes_what_the_jax_cli_writes(runtimes, tmp_path):
    jm, tm = runtimes
    for rt in (jm, tm):
        rt.keep_ratio, rt.enable_nms = True, True
    src = tmp_path / "src"
    src.mkdir()
    for i, img in enumerate(_images()):
        cv2.imwrite(str(src / f"im{i}.jpg"), img)
    writer = cv2.VideoWriter(str(src / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (160, 120))
    rng = np.random.default_rng(3)
    for _ in range(5):
        writer.write(rng.integers(0, 256, (120, 160, 3)).astype(np.uint8))
    writer.release()
    label_to_name = {i: f"c{i}" for i in range(NC)}
    pad = {"w": 0.05, "h": 0.05}
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    jax_infer_folder(jm, src, out_j, label_to_name, to_crop=True, paddings=pad)
    infer_folder(tm, src, out_t, label_to_name, to_crop=True, paddings=pad)

    def files(root):
        return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())

    assert files(out_t) == files(out_j)
    assert (out_t / "images" / "clip_pred.mp4").stat().st_size > 0
    assert (out_t / "labels.txt").read_text() == (out_j / "labels.txt").read_text()
    for name in ("im0.txt", "im1.txt"):
        rows_t = [l.split() for l in (out_t / "labels" / name).read_text().splitlines()]
        rows_j = [l.split() for l in (out_j / "labels" / name).read_text().splitlines()]
        assert len(rows_t) == len(rows_j) > 0
        t, j = np.array(rows_t, float), np.array(rows_j, float)
        np.testing.assert_array_equal(t[:, 0], j[:, 0])
        np.testing.assert_allclose(t[:, 1:], j[:, 1:], atol=TOL)


def test_segment_task_and_yolo_wrapper_raise():
    """task="segment" builds the mask head (tests/test_torch_segment.py holds
    the segment runtime against the JAX one) and returns masks in the
    original frame; the ultralytics wrapper raises ImportError at
    construction where ultralytics is missing, as the JAX package's copy
    does."""
    from custom_d_fine_tpu.infer.yolo_model import YOLOModel as JYOLOModel
    from custom_d_fine_tpu_torch.infer.yolo_model import YOLOModel

    tm = TorchModel(None, "n", NC, img_size=IMG, task="segment", conf_thresh=0.0,
                    smoke_test=False, device="cpu")
    assert tm.model.decoder.enable_mask_head
    det = tm(_images()[0])[0]
    assert det["masks"].shape == (len(det["scores"]), 200, 300) and det["masks"].dtype == np.uint8
    for cls in (YOLOModel, JYOLOModel):
        with pytest.raises(ImportError, match="ultralytics"):
            cls("yolo.pt")
