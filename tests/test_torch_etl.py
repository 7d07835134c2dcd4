"""The port's ETL copies (custom_d_fine_tpu_torch/etl/{converters,hygiene}.py)
against the JAX package's on the same synthetic files: each function runs on
one copy of a dataset in each package, and the returned values and every
file written must be equal (JSON compared as data, with the copy's root
taken out of paths)."""

import json
import shutil

import cv2
import numpy as np
import pytest

from custom_d_fine_tpu.etl import converters as jconv
from custom_d_fine_tpu.etl import hygiene as jhyg
from custom_d_fine_tpu_torch.etl import converters as tconv
from custom_d_fine_tpu_torch.etl import hygiene as thyg


def _dataset(root):
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    (root / "masks").mkdir()
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (100, 120, 3)).astype(np.uint8)
    for i in range(6):
        img = base.copy() if i in (2, 3) else rng.integers(0, 255, (100, 120, 3)).astype(np.uint8)
        if i == 3:  # a near-duplicate of image 2
            img[:2, :2] = 0
        ext = "png" if i == 5 else "jpg"
        cv2.imwrite(str(root / "images" / f"a{i}.{ext}"), img)
        lines = [f"{i % 3} 0.5 0.5 0.2 0.3"]
        if i == 0:
            lines.append("1 0.1 0.1 0.4 0.1 0.4 0.4 0.1 0.4")
        (root / "labels" / f"a{i}.txt").write_text("\n".join(lines) + "\n" if i != 4 else "")
        mask = np.zeros((100, 120), np.uint8)
        cv2.circle(mask, (30 + 10 * i, 50), 15, 255, -1)
        cv2.rectangle(mask, (80, 10), (110, 30), 255, -1)
        cv2.imwrite(str(root / "masks" / f"a{i}.png"), mask)
    (root / "train.csv").write_text("a0.jpg\na1.jpg\na2.jpg\nmissing.jpg\n")
    (root / "val.csv").write_text("a3.jpg\na4.jpg\n")
    return root


@pytest.fixture()
def pair(tmp_path):
    a = _dataset(tmp_path / "t")
    b = tmp_path / "j"
    shutil.copytree(a, b)
    return a, b


def _tree(root):
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel = p.relative_to(root).as_posix()
            if p.suffix in (".jpg", ".png"):
                out[rel] = cv2.imread(str(p), cv2.IMREAD_UNCHANGED).tobytes()
            elif p.suffix == ".json":
                out[rel] = json.loads(p.read_text())
            else:
                out[rel] = p.read_bytes().replace(str(root).encode(), b"<root>")
    return out


def _same(fn_t, fn_j, pair, rel=lambda v, root: v):
    a, b = pair
    ra, rb = fn_t(a), fn_j(b)
    assert rel(ra, a) == rel(rb, b)
    assert _tree(a) == _tree(b)
    return ra


def test_yolo_to_coco_and_back(pair):
    n = _same(lambda r: tconv.yolo_to_coco(r / "images", r / "labels", r / "coco.json",
                                           {0: "x", 1: "y"}),
              lambda r: jconv.yolo_to_coco(r / "images", r / "labels", r / "coco.json",
                                           {0: "x", 1: "y"}), pair)
    assert n == 6
    _same(lambda r: tconv.coco_to_yolo(r / "coco.json", r / "labels2"),
          lambda r: jconv.coco_to_yolo(r / "coco.json", r / "labels2"), pair)


def test_png_masks_and_polys_to_bboxes(pair):
    n = _same(lambda r: tconv.png_masks_to_yolo(r / "masks", r / "poly", class_id=2),
              lambda r: jconv.png_masks_to_yolo(r / "masks", r / "poly", class_id=2), pair)
    assert n == 6
    _same(lambda r: tconv.polys_to_bboxes(r / "poly", r / "bbox"),
          lambda r: jconv.polys_to_bboxes(r / "poly", r / "bbox"), pair)


def test_ultralytics_layout_roundtrip(pair):
    names = {0: "x", 1: "y", 2: "z"}
    _same(lambda r: tconv.csv_split_to_ultralytics(r, r / "ul", names),
          lambda r: jconv.csv_split_to_ultralytics(r, r / "ul", names), pair)
    _same(lambda r: tconv.ultralytics_to_csv_split(r / "ul", r / "back"),
          lambda r: jconv.ultralytics_to_csv_split(r / "ul", r / "back"), pair)


def test_preprocess_and_duplicates(pair):
    assert _same(lambda r: thyg.preprocess_images(r / "images", r / "labels", workers=2),
                 lambda r: jhyg.preprocess_images(r / "images", r / "labels", workers=2),
                 pair) == 1
    groups = _same(lambda r: thyg.find_near_duplicates(r / "images", max_hamming=6),
                   lambda r: jhyg.find_near_duplicates(r / "images", max_hamming=6), pair,
                   rel=lambda g, root: [[p.relative_to(root) for p in grp] for grp in g])
    assert len(groups) >= 1
    img = cv2.imread(str(pair[0] / "images" / "a0.jpg"))
    assert thyg._phash(img) == jhyg._phash(img)
    _same(lambda r: thyg.remove_duplicates(r / "images", r / "labels", max_hamming=6),
          lambda r: jhyg.remove_duplicates(r / "images", r / "labels", max_hamming=6), pair)


@pytest.mark.parametrize("remap", [True, False])
def test_remove_class_clean_csv_create_test_csv(pair, remap):
    _same(lambda r: thyg.remove_class(r / "labels", 1, remap=remap),
          lambda r: jhyg.remove_class(r / "labels", 1, remap=remap), pair)
    assert _same(lambda r: thyg.clean_csv(r), lambda r: jhyg.clean_csv(r), pair)["train"] == 1
    _same(lambda r: thyg.create_test_csv(r / "images", r / "test.csv"),
          lambda r: jhyg.create_test_csv(r / "images", r / "test.csv"), pair)
