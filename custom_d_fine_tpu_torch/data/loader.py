"""Loader: split CSVs -> datasets -> threaded prefetching batch iterator.

Parity target: reference src/dl/dataset.py:471-694 (Loader): reads
{train,val,test}.csv, logs label statistics + background-image counts, builds
DataLoaders with seeded workers and prefetch, collate to stacked batches,
multiscale batch resize (+-{32,64}px with re-thresholded masks).

The port's copy of custom_d_fine_tpu/data/loader.py: instead of torch
DataLoader processes, a thread pool prefetches samples (cv2/numpy release
the GIL) and batches are plain numpy dicts with static shapes, which the
Trainer moves to the card. Under torch.distributed each process iterates its
stride of every split (parallel/dist.py gives the rank and world size).
"""

from __future__ import annotations

from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import cv2
import numpy as np
from ..parallel.dist import world
from ..utils.logging import logger
from .dataset import DFineDataset


def read_split_csv(path: Path) -> List[str]:
    names = []
    for line in Path(path).read_text().splitlines():
        line = line.strip().split(",")[0]
        if line and line != "name":
            names.append(line)
    return names


class BatchIterator:
    """One epoch of batches with threaded prefetch."""

    def __init__(self, dataset: DFineDataset, order: np.ndarray, batch_size: int,
                 num_workers: int, drop_last: bool, multiscale_prob: float,
                 rng: np.random.Generator, prefetch: int = 4,
                 multiscale_deltas=(-64, -32, 32, 64)):
        self.dataset = dataset
        self.order = order
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.multiscale_prob = multiscale_prob
        self.multiscale_deltas = tuple(multiscale_deltas)
        self.rng = rng
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.order)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, samples: List[Dict]) -> Dict[str, np.ndarray]:
        samples = [s for s in samples if s is not None]
        batch = {
            "images": np.stack([s["image"] for s in samples]),
            "labels": np.stack([s["labels"] for s in samples]),
            "boxes": np.stack([s["boxes"] for s in samples]),
            "valid": np.stack([s["valid"] for s in samples]),
            "paths": [s["path"] for s in samples],
            "orig_sizes": np.stack([s["orig_size"] for s in samples]),
            "letterbox": [s["letterbox"] for s in samples],
        }
        if "masks" in samples[0]:
            batch["masks"] = np.stack([s["masks"] for s in samples])

        # multiscale: resize the whole batch by +-{32,64}px; normalized boxes
        # untouched (reference dataset.py:667-694)
        if self.multiscale_prob > 0 and self.rng.random() < self.multiscale_prob:
            delta = int(self.rng.choice(self.multiscale_deltas))
            h = batch["images"].shape[1] + delta
            w = batch["images"].shape[2] + delta
            batch["images"] = np.stack([
                cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR)
                for im in batch["images"]
            ])
            if "masks" in batch:
                mh, mw = h // self.dataset.mask_downsample, w // self.dataset.mask_downsample
                B, G = batch["masks"].shape[:2]
                out = np.zeros((B, G, mh, mw), np.uint8)
                for i in range(B):
                    for g in range(G):
                        if batch["masks"][i, g].any():
                            out[i, g] = (cv2.resize(
                                batch["masks"][i, g].astype(np.float32), (mw, mh),
                                interpolation=cv2.INTER_LINEAR) > 0.5).astype(np.uint8)
                batch["masks"] = out
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.order)
        ends = range(self.batch_size, n + 1, self.batch_size) if self.drop_last else \
            range(self.batch_size, n + self.batch_size, self.batch_size)
        index_batches = [self.order[max(0, e - self.batch_size):min(e, n)] for e in ends]
        index_batches = [b for b in index_batches if len(b)]

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            it = iter(index_batches)
            for _ in range(self.prefetch):
                idxs = next(it, None)
                if idxs is None:
                    break
                pending.append(pool.submit(
                    lambda ii: [self.dataset[int(i)] for i in ii], idxs))
            while pending:
                fut = pending.pop(0)
                idxs = next(it, None)
                if idxs is not None:
                    pending.append(pool.submit(
                        lambda ii: [self.dataset[int(i)] for i in ii], idxs))
                samples = [s for s in fut.result() if s is not None]
                if samples:
                    yield self._collate(samples)


class Loader:
    """Builds train/val/test iterators from a YOLO dataset directory with
    {train,val,test}.csv splits (reference dataset.py:471-637)."""

    def __init__(
        self,
        root_path: Path,
        img_size,
        batch_size: int,
        num_workers: int = 4,
        max_gt: int = 100,
        task: str = "detect",
        keep_ratio: bool = False,
        use_one_class: bool = False,
        aug_cfg=None,
        mosaic_cfg=None,
        multiscale_prob: float = 0.0,
        multiscale_deltas=(-64, -32, 32, 64),
        seed: int = 42,
        label_to_name: Optional[Dict[int, str]] = None,
        mask_downsample: int = 4,
        debug_img_path=None,
    ):
        self.root_path = Path(root_path)
        self.img_size = tuple(img_size)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.multiscale_prob = multiscale_prob
        self.multiscale_deltas = tuple(multiscale_deltas)
        self.seed = seed
        self.rng = np.random.default_rng(seed)

        common = dict(
            root_path=self.root_path, img_size=self.img_size, max_gt=max_gt,
            task=task, keep_ratio=keep_ratio, use_one_class=use_one_class,
            aug_cfg=aug_cfg, mosaic_cfg=mosaic_cfg, seed=seed,
            mask_downsample=mask_downsample, debug_img_path=debug_img_path,
        )
        self.datasets: Dict[str, DFineDataset] = {}
        for split in ("train", "val", "test"):
            csv = self.root_path / f"{split}.csv"
            if csv.exists():
                names = read_split_csv(csv)
                mode = split if split != "test" else "test"
                self.datasets[split] = DFineDataset(names=names, mode=mode if split != "train" else "train", **common)
            else:
                self.datasets[split] = None

        if label_to_name and self.datasets.get("train"):
            self._log_stats(label_to_name)

    def _log_stats(self, label_to_name: Dict[int, str]) -> None:
        """Label statistics + background counts (reference dataset.py:506-550)."""
        for split, ds in self.datasets.items():
            if ds is None:
                continue
            counts: Counter = Counter()
            background = 0
            for name in ds.names:
                lp = ds.root_path / "labels" / f"{Path(name).stem}.txt"
                if not lp.exists() or lp.stat().st_size <= 1:
                    background += 1
                    continue
                try:
                    from .yolo import parse_yolo_label_file

                    boxes, _ = parse_yolo_label_file(lp)
                    counts.update(boxes[:, 0].astype(int).tolist())
                except Exception:
                    continue
            stats = {label_to_name.get(k, k): v for k, v in sorted(counts.items())}
            logger.info(f"{split}: {len(ds)} images, {background} background, labels: {stats}")

    def epoch_iterator(self, split: str, epoch: int = 0, shuffle: Optional[bool] = None,
                       drop_last: Optional[bool] = None,
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> BatchIterator:
        """One epoch of batches; on a multi-host slice each process iterates
        only its stride of the dataset (reference DistributedSampler,
        dataset.py:562-568): identical seeded shuffle on every process, then
        rank::nranks striding. Train epochs wrap-pad to equal per-process
        length (torch semantics, keeps step counts in lockstep); eval splits
        are NOT padded — per-process counts may differ by one batch and
        gather_objects reassembles the exact dataset with no duplicates.
        process_index/count default to the torch.distributed process group's
        rank and world size ((0, 1) without one)."""
        ds = self.datasets[split]
        assert ds is not None, f"no {split}.csv in {self.root_path}"
        if shuffle is None:
            shuffle = split == "train"
        if drop_last is None:
            drop_last = split == "train"
        order = np.arange(len(ds))
        if shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)

        if process_count is None or process_index is None:
            process_count, process_index = world()
        if process_count > 1:
            if split == "train" and len(order) % process_count:
                # wrap-pad so every process runs the same number of steps
                # (each step's all-reduces are collectives: a process that
                # stops early hangs the others — gate on the SPLIT, not on
                # shuffle, so shuffle=False stays in lockstep)
                total = -(-len(order) // process_count) * process_count
                order = np.concatenate([order, order[: total - len(order)]])
            order = order[process_index::process_count]
        return BatchIterator(
            ds, order, self.batch_size, self.num_workers, drop_last,
            self.multiscale_prob if split == "train" else 0.0,
            self.rng,
            multiscale_deltas=self.multiscale_deltas,
        )
