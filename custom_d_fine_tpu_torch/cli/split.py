"""Dataset split: images dir -> {train,val,test}.csv (a copy of
custom_d_fine_tpu/cli/split.py).

Parity target: reference src/etl/split.py:10-72 (sklearn-based shuffled
train/val/test split, optional negative filtering).
Usage: python -m custom_d_fine_tpu_torch.cli.split [--config cfg] [k=v ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

IMG_EXT = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def split_dataset(data_path: Path, train_split: float, val_split: float,
                  shuffle: bool = True, ignore_negatives: bool = False, seed: int = 42):
    images = sorted(p.name for p in (data_path / "images").iterdir()
                    if p.suffix.lower() in IMG_EXT)
    if ignore_negatives:
        def has_labels(name):
            lp = data_path / "labels" / f"{Path(name).stem}.txt"
            return lp.exists() and lp.stat().st_size > 1
        images = [n for n in images if has_labels(n)]

    order = np.arange(len(images))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = len(images)
    n_train = int(n * train_split)
    n_val = int(n * val_split)
    splits = {
        "train": [images[i] for i in order[:n_train]],
        "val": [images[i] for i in order[n_train:n_train + n_val]],
        "test": [images[i] for i in order[n_train + n_val:]],
    }
    for name, names in splits.items():
        if not names and name == "test":
            continue
        (data_path / f"{name}.csv").write_text("\n".join(names) + ("\n" if names else ""))
        print(f"{name}: {len(names)} images")
    return splits


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    from ..utils.config import load_config

    cfg = load_config(args.config, args.overrides)
    split_dataset(
        Path(cfg["train"]["data_path"]),
        cfg["split"]["train_split"], cfg["split"]["val_split"],
        shuffle=cfg["split"].get("shuffle", True),
        ignore_negatives=cfg["split"].get("ignore_negatives", False),
        seed=cfg["train"].get("seed", 42),
    )


if __name__ == "__main__":
    main()
