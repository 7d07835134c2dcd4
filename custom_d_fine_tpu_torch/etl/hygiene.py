"""Dataset hygiene tools (host code; a copy of custom_d_fine_tpu/etl/hygiene.py).

Parity targets (reference src/etl/):
- preprocess.py:12-79 — convert tif/png/heic->jpg, EXIF rotation fix, delete
  empty label files (multiprocessing pool -> thread pool here; cv2 releases
  the GIL)
- remove_dups.py:9-38 — near-duplicate removal (difPy -> perceptual-hash
  clustering, no external dependency)
- remove_class.py:10-40 — delete a class id from all labels (remap the rest)
- clean_csv.py:9-18 — drop CSV rows whose images are missing
- create_test_csv.py:7-15 — build a test CSV from a folder listing
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import cv2
import numpy as np

IMG_EXT = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}


def preprocess_images(images_dir: Path, labels_dir: Optional[Path] = None,
                      quality: int = 95, workers: int = 8) -> int:
    """Convert non-jpg images to jpg (EXIF orientation applied by cv2 imread),
    delete empty label files."""
    images_dir = Path(images_dir)
    converted = 0

    def convert(p: Path):
        nonlocal converted
        if p.suffix.lower() in (".jpg", ".jpeg"):
            return
        img = cv2.imread(str(p), cv2.IMREAD_COLOR)
        if img is None:
            return
        cv2.imwrite(str(p.with_suffix(".jpg")), img,
                    [cv2.IMWRITE_JPEG_QUALITY, quality])
        p.unlink()
        converted += 1

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(convert, [p for p in images_dir.iterdir()
                                if p.suffix.lower() in IMG_EXT]))

    if labels_dir:
        for lp in Path(labels_dir).glob("*.txt"):
            if lp.stat().st_size <= 1:
                lp.unlink()
    return converted


def _phash(img: np.ndarray, size: int = 8) -> int:
    """Perceptual hash: DCT low-frequency signs."""
    g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    g = cv2.resize(g, (32, 32), interpolation=cv2.INTER_AREA).astype(np.float32)
    dct = cv2.dct(g)[:size, :size]
    med = np.median(dct[1:, 1:])
    bits = (dct > med).astype(np.uint8).reshape(-1)
    return int("".join(map(str, bits)), 2)


def find_near_duplicates(images_dir: Path, max_hamming: int = 4) -> List[List[Path]]:
    """Group near-duplicate images by perceptual hash distance
    (stands in for difPy, reference remove_dups.py:9-38)."""
    images_dir = Path(images_dir)
    hashes = []
    for p in sorted(images_dir.iterdir()):
        if p.suffix.lower() not in IMG_EXT:
            continue
        img = cv2.imread(str(p))
        if img is None:
            continue
        hashes.append((p, _phash(img)))

    groups: List[List[Path]] = []
    used = set()
    for i, (p1, h1) in enumerate(hashes):
        if p1 in used:
            continue
        group = [p1]
        for p2, h2 in hashes[i + 1:]:
            if p2 in used:
                continue
            if bin(h1 ^ h2).count("1") <= max_hamming:
                group.append(p2)
                used.add(p2)
        if len(group) > 1:
            groups.append(group)
            used.update(group)
    return groups


def remove_duplicates(images_dir: Path, labels_dir: Optional[Path] = None,
                      max_hamming: int = 4) -> int:
    """Keep the first image of each near-duplicate group, delete the rest."""
    removed = 0
    for group in find_near_duplicates(images_dir, max_hamming):
        for p in group[1:]:
            p.unlink(missing_ok=True)
            if labels_dir:
                (Path(labels_dir) / f"{p.stem}.txt").unlink(missing_ok=True)
            removed += 1
    return removed


def remove_class(labels_dir: Path, class_id: int, remap: bool = True) -> int:
    """Delete one class from all label files; optionally shift ids above it
    down by one (reference remove_class.py:10-40)."""
    n = 0
    for lp in sorted(Path(labels_dir).glob("*.txt")):
        lines_out = []
        changed = False
        for line in lp.read_text().splitlines():
            parts = line.split()
            if not parts:
                continue
            cid = int(float(parts[0]))
            if cid == class_id:
                changed = True
                continue
            if remap and cid > class_id:
                parts[0] = str(cid - 1)
                changed = True
            lines_out.append(" ".join(parts))
        if changed:
            lp.write_text("\n".join(lines_out) + ("\n" if lines_out else ""))
            n += 1
    return n


def clean_csv(data_path: Path) -> Dict[str, int]:
    """Drop split-CSV rows whose image files are missing
    (reference clean_csv.py:9-18)."""
    from ..data.loader import read_split_csv

    data_path = Path(data_path)
    dropped = {}
    for split in ("train", "val", "test"):
        csv = data_path / f"{split}.csv"
        if not csv.exists():
            continue
        names = read_split_csv(csv)
        kept = [n for n in names if (data_path / "images" / n).exists()]
        dropped[split] = len(names) - len(kept)
        csv.write_text("\n".join(kept) + ("\n" if kept else ""))
    return dropped


def create_test_csv(folder: Path, out_csv: Path) -> int:
    """Build a test CSV from a folder listing (reference create_test_csv.py:7-15)."""
    names = sorted(p.name for p in Path(folder).iterdir()
                   if p.suffix.lower() in IMG_EXT)
    Path(out_csv).write_text("\n".join(names) + ("\n" if names else ""))
    return len(names)
