"""The port's data layer (custom_d_fine_tpu_torch/data/*) against the JAX
package's (custom_d_fine_tpu/data/*): the same synthetic YOLO set, the same
seed, and the batches must be equal, element for element (both run the same
OpenCV and numpy calls).

The set mixes image sizes (landscape and portrait, so the letterbox pads
both ways), 1-5 objects an image, polygon rows (boxes from the polygon's
extent; masks in the segment task) and one background image. Every
augmentation is switched on with probability 0.5, mosaic at 0.5 and the
multiscale resize at 0.5. num_workers=1: the loader's prefetch threads share
the dataset's random generator, so with more threads the draws interleave
in whichever order the threads run, in both packages.
"""

import cv2
import numpy as np
import pytest

from custom_d_fine_tpu.data.augs import AugConfig as JAugConfig
from custom_d_fine_tpu.data.loader import Loader as JLoader
from custom_d_fine_tpu.data.mosaic import MosaicConfig as JMosaicConfig
from custom_d_fine_tpu_torch.data.augs import AugConfig
from custom_d_fine_tpu_torch.data.loader import Loader
from custom_d_fine_tpu_torch.data.mosaic import MosaicConfig

AUGS = dict(rotation_degree=10, rotation_p=0.5, rotate_90=0.5, left_right_flip=0.5,
            up_down_flip=0.5, to_gray=0.5, blur=0.5, gamma=0.5, brightness=0.5, noise=0.5,
            coarse_dropout=0.5)
MOSAIC = dict(mosaic_prob=0.5, no_mosaic_epochs=0, mosaic_scale=(0.5, 1.5), degrees=5.0,
              translate=0.2, shear=2.0)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("datads")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(3)
    names = []
    for i in range(14):
        h, w = ((120, 160), (160, 120), (96, 96))[i % 3]
        img = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        lines = []
        for _ in range(0 if i == 5 else int(rng.integers(1, 6))):
            cx, cy = rng.uniform(0.25, 0.75, 2)
            bw, bh = rng.uniform(0.1, 0.4, 2)
            cls = int(rng.integers(0, 3))
            x1, y1 = int((cx - bw / 2) * w), int((cy - bh / 2) * h)
            img[y1:y1 + int(bh * h), x1:x1 + int(bw * w)] = (60 * cls, 255, 32)
            if rng.random() < 0.4:  # a polygon row: a diamond inside the box
                pts = [(cx, cy - bh / 2), (cx + bw / 2, cy), (cx, cy + bh / 2), (cx - bw / 2, cy)]
                lines.append(f"{cls} " + " ".join(f"{x:.5f} {y:.5f}" for x, y in pts))
            else:
                lines.append(f"{cls} {cx:.5f} {cy:.5f} {bw:.5f} {bh:.5f}")
        name = f"im{i}.png"
        cv2.imwrite(str(root / "images" / name), img)
        (root / "labels" / f"im{i}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))
        names.append(name)
    (root / "train.csv").write_text("\n".join(names[:10]) + "\n")
    (root / "val.csv").write_text("\n".join(names[10:]) + "\n")
    return root


def _loaders(root, task, keep_ratio):
    kw = dict(root_path=root, img_size=(128, 128), batch_size=3, num_workers=1, max_gt=8,
              task=task, keep_ratio=keep_ratio, multiscale_prob=0.5,
              multiscale_deltas=(-32, 32), seed=7, label_to_name={0: "a", 1: "b", 2: "c"},
              mask_downsample=4)
    return (JLoader(aug_cfg=JAugConfig(**AUGS), mosaic_cfg=JMosaicConfig(**MOSAIC), **kw),
            Loader(aug_cfg=AugConfig(**AUGS), mosaic_cfg=MosaicConfig(**MOSAIC), **kw))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("task,keep_ratio", [("detect", False), ("detect", True),
                                             ("segment", True)])
def test_loader_matches_jax(dataset_root, task, keep_ratio):
    """Two train epochs (mosaic, augs and multiscale draw from the seeded
    generators) and the val split, batch for batch."""
    jl, tl = _loaders(dataset_root, task, keep_ratio)
    sizes = set()
    for epoch in (1, 2):
        got = list(tl.epoch_iterator("train", epoch=epoch))
        _assert_batches_equal(got, list(jl.epoch_iterator("train", epoch=epoch)))
        sizes |= {b["images"].shape[1] for b in got}
    assert len(sizes) > 1  # some batch took the multiscale resize
    _assert_batches_equal(list(tl.epoch_iterator("val")), list(jl.epoch_iterator("val")))
    if task == "segment":
        assert any(b["masks"].any() for b in tl.epoch_iterator("val"))


def test_loader_rank_shards_match_jax(dataset_root):
    """Each process's stride of the seeded order: train wrap-padded to equal
    length on every rank (10 images on 3 ranks -> 4 each), val not padded."""
    jl, tl = _loaders(dataset_root, "detect", False)
    for split in ("train", "val"):
        seen = []
        for rank in range(3):
            kw = dict(epoch=1, process_index=rank, process_count=3)
            got = tl.epoch_iterator(split, **kw)
            want = jl.epoch_iterator(split, **kw)
            np.testing.assert_array_equal(got.order, want.order)
            seen.append(got.order)
        if split == "train":
            assert [len(o) for o in seen] == [4, 4, 4]
        else:
            assert sorted(np.concatenate(seen).tolist()) == list(range(4))
