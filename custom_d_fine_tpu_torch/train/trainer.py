"""Training orchestration: loader -> train step on the card -> EMA eval ->
checkpoints. Counterpart of custom_d_fine_tpu/train/trainer.py (reference
src/dl/train.py:76-752): the epoch loop with the mosaic close and
ignore_background_epochs, multiscale batches, loss fetched only at log
points, eval of the EMA with letterbox unmapping, decision-metric model
selection and early stopping, rank-0 logs, CSV and plots, and checkpoints
that resume a run.

Data parallelism is torch.distributed with one process per card
(parallel/dist.py): every process builds the same Trainer, iterates its
stride of each split, and takes the same update; evaluation gathers every
process's predictions, so every process computes the same metrics and
makes the same early-stop and best-model decisions.

Checkpoints are torch.save files written by rank 0: `last.pt` holds the
model, the EMA, the Optimizer (AdamW state, count, mini_step, acc), step,
epoch, best_metric and epochs_no_improve; `model.pt` holds the weights only
(model and EMA). Both put the EMA under {"ema": {"module": ...}}, so
utils/checkpoint.py loads either as pretrained weights, as the reference's
files load.

Not ported, because they work around the TPU or its host:
steps_per_dispatch / make_train_multi_step (a lax.scan over K steps that
hides the TPU host's dispatch), _precompile_multiscale (the eager port has
nothing to compile per canvas size), orbax, and _put_global / _shard_batch /
_pad_to_mesh (each process holds its own rows; nothing pads to a mesh).

Task "segment" builds the mask head, trains the mask losses, chooses the
model by the mask mAPs and evaluates the predicted and GT masks as RLE in
the original frame.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np
import torch

from ..configs.registry import ModelConfig, get_model_config
from ..data.augs import AugConfig
from ..data.letterbox import unletterbox_boxes_abs
from ..data.loader import Loader
from ..data.mosaic import MosaicConfig
from ..deploy.serving import resolve_device
from ..eval.rle import masks_to_rle
from ..eval.validator import Validator
from ..infer.model import masks_to_frame
from ..models.dfine import build_model
from ..parallel import dist
from ..utils.checkpoint import (
    load_hgnetv2_pretrained,
    load_matched,
    load_torch_checkpoint_file,
    remap_obj365_head,
)
from ..utils.logging import logger
from .criterion import DFINECriterion, with_mask_losses
from .optim import Optimizer
from .train_step import create_train_state, make_eval_step, make_train_step

LOG_EVERY = 50  # steps between loss fetches (each waits for the card)


def unletterbox_or_resize_boxes(boxes_canvas_xyxy, lb: Dict, orig_h: int, orig_w: int):
    """Map canvas-abs xyxy boxes back to the original image (reference
    dl/utils.py process_boxes)."""
    if lb.get("ratio") is not None:
        return unletterbox_boxes_abs(boxes_canvas_xyxy, lb, orig_h, orig_w)
    b = boxes_canvas_xyxy.copy()
    b[:, [0, 2]] = np.clip(b[:, [0, 2]] / lb["ratio_x"], 0, orig_w)
    b[:, [1, 3]] = np.clip(b[:, [1, 3]] / lb["ratio_y"], 0, orig_h)
    return b


def _gt_masks_rle(masks: np.ndarray, oh: int, ow: int) -> List[Dict]:
    """GT masks at the mask resolution -> RLE in the original frame, resized
    and binarised as the predictions are (JAX trainer.py:619-630)."""
    gms = [(cv2.resize(m.astype(np.float32), (ow, oh), interpolation=cv2.INTER_LINEAR)
            > 0.5).astype(np.uint8) for m in masks]
    return masks_to_rle(np.stack(gms)) if gms else []


class Trainer:
    """cfg: the experiment dict of utils/config.py:load_config (any dict of
    that layout). Runs on the card unless cfg["train"]["device"] says "cpu";
    bfloat16 (the default dtype) runs only on the card."""

    def __init__(self, cfg: Dict, model_cfg_override: Optional[ModelConfig] = None):
        self.cfg = cfg
        t = cfg["train"]
        self.task = cfg.get("task", "detect")
        self.enable_mask_head = self.task == "segment"
        self.device = resolve_device(t.get("device"))
        self.bf16 = t.get("dtype") == "bfloat16"
        if self.bf16 and self.device.type != "cuda":
            raise ValueError("dtype bfloat16 trains on the card; set train.dtype=float32 on "
                             "the CPU")
        self.label_to_name = {int(k): v for k, v in t["label_to_name"].items()}
        self.num_labels = len(self.label_to_name)
        self.img_size = tuple(t["img_size"])
        self.epochs = t["epochs"]
        self.b_accum_steps = max(int(t.get("b_accum_steps", 1)), 1)
        self.conf_thresh = t["conf_thresh"]
        self.iou_thresh = t["iou_thresh"]
        self.early_stopping = t.get("early_stopping", 0)
        self.ignore_background_epochs = t.get("ignore_background_epochs", 0)
        self.no_mosaic_epochs = t["mosaic_augs"]["no_mosaic_epochs"]
        self.use_ema = t.get("use_ema", True)
        self.decision_metrics = list(t.get("decision_metrics", ["f1"]))
        if self.enable_mask_head:
            self.decision_metrics = [m + "_mask" if m.startswith("mAP_50") else m
                                     for m in self.decision_metrics]
        self.is_main = dist.is_main_process()
        self.path_to_save = Path(t["path_to_save"])
        if self.is_main:
            self.path_to_save.mkdir(parents=True, exist_ok=True)
            logger.add(self.path_to_save / "train_log.txt")
        logger.info(f"Experiment: {cfg.get('exp', 'exp')}, Task: {self.task}, "
                    f"device {self.device}, processes {dist.world()[0]}")

        self._wandb = None
        if t.get("use_wandb") and self.is_main:
            try:
                import wandb

                wandb.init(project=cfg.get("project_name", "d_fine_tpu"),
                           name=cfg.get("exp"), config=dict(cfg))
                self._wandb = wandb
            except ImportError:
                logger.warning("use_wandb=true but wandb is not installed; skipping")

        # ---- data
        self.model_cfg = model_cfg_override or get_model_config(
            cfg["model_name"], enable_mask_head=self.enable_mask_head,
            max_gt=int(t.get("max_gt", 100)))
        augs = dict(t["augs"])
        self.loader = Loader(
            root_path=Path(t["data_path"]),
            img_size=self.img_size,
            batch_size=t["batch_size"],
            num_workers=t.get("num_workers", 4),
            max_gt=self.model_cfg.max_gt,
            task=self.task,
            keep_ratio=t.get("keep_ratio", False),
            use_one_class=t.get("use_one_class", False),
            aug_cfg=AugConfig(**augs),
            mosaic_cfg=MosaicConfig(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in t["mosaic_augs"].items()
            }),
            multiscale_prob=augs.get("multiscale_prob", 0.0),
            multiscale_deltas=tuple(augs.get("multiscale_deltas", (-64, -32, 32, 64))),
            seed=t.get("seed", 42),
            label_to_name=self.label_to_name,
            # GT masks at the mask head's resolution: the finest level's stride / 2
            mask_downsample=self.model_cfg.encoder.feat_strides[0] // 2,
            debug_img_path=(t.get("debug_img_path")
                            if t.get("debug_img_processing") else None),
        )
        if self.ignore_background_epochs:
            self.loader.datasets["train"].ignore_background = True

        # ---- model, criterion, optimizer, EMA
        model = build_model(self.model_cfg, num_classes=self.num_labels,
                            seed=t.get("seed", 42))
        b = self.model_cfg.backbone
        if b.pretrained and not t.get("pretrained_model_path"):
            rep = load_hgnetv2_pretrained(model, b.name, b.local_model_dir)
            if "error" not in rep:
                logger.info(f"Loaded pretrained HGNetv2 {b.name}: {len(rep['missed'])} "
                            f"backbone keys missed, {len(rep['unmatched'])} unmatched")
        if t.get("pretrained_model_path"):
            self._load_pretrained(model, t["pretrained_model_path"])
        model = model.to(self.device).to(memory_format=torch.channels_last).train()

        crit_cfg = self.model_cfg.criterion
        if self.enable_mask_head:
            crit_cfg = with_mask_losses(crit_cfg)
        if t.get("label_smoothing", 0.0):
            crit_cfg = dataclasses.replace(crit_cfg,
                                           label_smoothing=float(t["label_smoothing"]))
        criterion = DFINECriterion(crit_cfg, self.model_cfg.matcher,
                                   num_classes=self.num_labels)
        steps_per_epoch = max(len(self.loader.epoch_iterator("train")) // self.b_accum_steps, 1)
        optimizer = Optimizer(
            model, self.model_cfg,
            base_lr=t["base_lr"], backbone_lr=t["backbone_lr"],
            weight_decay=t.get("weight_decay", 0.000125),
            betas=tuple(t.get("betas", (0.9, 0.999))),
            total_steps=steps_per_epoch * self.epochs,
            pct_start=t.get("cycler_pct_start", 0.1),
            use_scheduler=t.get("use_scheduler", True),
            clip_max_norm=t.get("clip_max_norm", 0.1),
            b_accum_steps=self.b_accum_steps,
        )
        self.state = create_train_state(model, optimizer, use_ema=self.use_ema)
        self.train_step = make_train_step(criterion, ema_momentum=t.get("ema_momentum", 0.9998),
                                          b_accum_steps=self.b_accum_steps, bf16=self.bf16)
        self.eval_step = make_eval_step(use_ema=self.use_ema, bf16=self.bf16)
        # the denoising noise: the same stream on every process (train_step.py)
        self.dn_generator = torch.Generator().manual_seed(int(t.get("seed", 42)))

        self.epoch = 0  # epochs finished (a resumed run starts after it)
        self.best_metric = -1.0
        self.epochs_no_improve = 0
        self.timings: List[Dict[str, float]] = []  # one entry per epoch

    # ------------------------------------------------------------ pretrained

    def _load_pretrained(self, model, path: str) -> None:
        """reference load_tuning_state (d_fine/utils.py:156-181) + obj365 remap."""
        logger.info(f"Loading pretrained weights from {path}")
        state = remap_obj365_head(load_torch_checkpoint_file(path), self.num_labels)
        report = load_matched(model, state)
        n_bad = len(report["unmatched"]) + len(report["shape_mismatch"])
        logger.info(f"Pretrained load: {len(report['missed'])} missed, "
                    f"{n_bad} unmatched/mismatched")

    # ------------------------------------------------------------ train loop

    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(batch[k]).to(self.device)
                for k in ("images", "labels", "boxes", "valid", "masks") if k in batch}

    def train(self) -> List[Dict]:
        t0 = time.time()
        metrics_history: List[Dict] = []
        train_ds = self.loader.datasets["train"]
        close_mosaic_at = self.epochs - self.no_mosaic_epochs + 1
        for epoch in range(self.epoch + 1, self.epochs + 1):
            # "<=" rather than "==": a resumed run may start past either epoch
            if 1 <= close_mosaic_at <= epoch and train_ds.mosaic_prob > 0:
                logger.info("Closing mosaic augmentation")
                train_ds.close_mosaic()
            if epoch > self.ignore_background_epochs and train_ds.ignore_background:
                train_ds.ignore_background = False
                logger.info("Including background images")

            epoch_losses = []
            it = self.loader.epoch_iterator("train", epoch=epoch)
            n_batches = len(it)
            t_epoch = time.perf_counter()
            wait, n_images = 0.0, 0
            t_wait = time.perf_counter()
            for i, batch in enumerate(it):
                wait += time.perf_counter() - t_wait
                n_images += batch["images"].shape[0]
                self.state, m = self.train_step(self.state, self._to_device(batch),
                                                self.dn_generator)
                if i % LOG_EVERY == 0 or i == n_batches - 1:
                    # the only fetch of the step's loss: this process's share,
                    # summed over the processes into the global batch's loss
                    loss_val = float(dist.global_sum(m["total_loss"]))
                    epoch_losses.append(loss_val)
                    dt = time.perf_counter() - t_epoch
                    eta = dt / (i + 1) * (n_batches - i - 1)
                    logger.info(f"epoch {epoch}/{self.epochs} step {i}/{n_batches} "
                                f"loss {loss_val:.3f} eta {eta / 60:.1f}m")
                t_wait = time.perf_counter()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t_train = time.perf_counter() - t_epoch

            t1 = time.perf_counter()
            metrics = self.evaluate("val")
            t_eval = time.perf_counter() - t1
            metrics["epoch"] = epoch
            metrics["train_loss"] = float(np.mean(epoch_losses)) if epoch_losses else 0.0
            metrics_history.append(metrics)
            self._log_metrics(metrics)
            self.epoch = epoch
            if dist.world()[0] > 1:  # every process took the same updates
                ema = [] if self.state.ema is None else list(self.state.ema.values())
                dist.check_replicas(list(self.state.model.state_dict().values()) + ema,
                                    "the model and EMA")
                logger.info(f"epoch {epoch}: the model and EMA are equal on all "
                            f"{dist.world()[0]} processes")
            t1 = time.perf_counter()
            self._save_and_maybe_stop(metrics)
            t_ckpt = time.perf_counter() - t1
            self.timings.append({"epoch": epoch, "steps": n_batches, "images": n_images,
                                 "train_s": t_train, "loader_wait_s": wait, "eval_s": t_eval,
                                 "checkpoint_s": t_ckpt,
                                 "epoch_s": time.perf_counter() - t_epoch})
            n_proc = dist.world()[0]
            logger.info(f"epoch {epoch} timings: {n_batches} steps, {n_images} images a "
                        f"process in {t_train:.2f} s ({n_images / t_train:.1f} img/s a "
                        f"process, {n_proc} processes), waiting on the loader {wait:.2f} s, "
                        f"eval {t_eval:.2f} s, checkpoints {t_ckpt:.2f} s, epoch "
                        f"{self.timings[-1]['epoch_s']:.2f} s")
            if self.early_stopping and self.epochs_no_improve >= self.early_stopping:
                logger.info("Early stopping triggered")
                break

        logger.info(f"Training finished in {(time.time() - t0) / 60:.1f} min")
        if self.is_main:
            self._write_csv(metrics_history, self.path_to_save / "metrics.csv")
        return metrics_history

    # ------------------------------------------------------------ evaluation

    def evaluate(self, split: str, extended: bool = False) -> Dict[str, float]:
        preds, gts = self.get_preds_and_gt(split)
        if not gts:
            return {}
        validator = Validator(
            gts, preds, self.label_to_name,
            conf_thresh=self.conf_thresh, iou_thresh=self.iou_thresh,
        )
        self._last_validator = validator
        return validator.compute_metrics(extended=extended)

    def get_preds_and_gt(self, split: str, visualize: Optional[bool] = None
                         ) -> Tuple[List[Dict], List[Dict]]:
        """reference get_preds_and_gt (train.py:376-434): EMA inference,
        postprocess to original image coordinates; the first 6 images are
        rendered side by side GT | pred when to_visualize_eval. Each process
        evaluates its stride of the split; the lists are gathered in rank
        order."""
        if visualize is None:
            visualize = bool(self.cfg["train"].get("to_visualize_eval"))
        visualize = visualize and self.is_main
        preds: List[Dict] = []
        gts: List[Dict] = []
        for batch in self.loader.epoch_iterator(split, shuffle=False, drop_last=False):
            images = torch.from_numpy(batch["images"]).to(self.device)
            dets = {k: v.cpu().numpy() for k, v in self.eval_step(self.state, images).items()}
            H, W = batch["images"].shape[1:3]
            for b in range(batch["images"].shape[0]):
                lb = batch["letterbox"][b]
                oh, ow = (int(x) for x in batch["orig_sizes"][b])
                boxes = unletterbox_or_resize_boxes(dets["boxes"][b], lb, oh, ow)
                scores = dets["scores"][b]
                labels = dets["labels"][b]
                keep = scores >= self.conf_thresh
                pred = {"boxes": boxes[keep], "labels": labels[keep], "scores": scores[keep],
                        "all_boxes": boxes, "all_labels": labels, "all_scores": scores}
                if self.enable_mask_head:  # JAX trainer.py:586-605; reference train.py:404-434
                    pred["masks_rle"] = masks_to_rle(
                        masks_to_frame(dets["masks"][b][keep], boxes[keep], oh, ow))
                preds.append(pred)

                v = batch["valid"][b]
                gb = batch["boxes"][b][v]  # normalized cxcywh on canvas
                if len(gb):
                    gt_canvas = np.stack([
                        (gb[:, 0] - gb[:, 2] / 2) * W, (gb[:, 1] - gb[:, 3] / 2) * H,
                        (gb[:, 0] + gb[:, 2] / 2) * W, (gb[:, 1] + gb[:, 3] / 2) * H,
                    ], 1)
                    xyxy = unletterbox_or_resize_boxes(gt_canvas, lb, oh, ow)
                else:
                    gt_canvas = xyxy = np.zeros((0, 4), np.float32)
                gt = {"boxes": xyxy, "labels": batch["labels"][b][v]}
                if self.enable_mask_head and "masks" in batch:
                    gt["masks_rle"] = _gt_masks_rle(batch["masks"][b][v], oh, ow)
                gts.append(gt)

                if visualize and len(preds) <= 6:
                    # GT | pred side by side in CANVAS coordinates
                    # (reference visualizes the first eval batches, train.py:418-426)
                    from ..utils.vis import save_gt_pred_pair

                    img = cv2.cvtColor(np.asarray(batch["images"][b]), cv2.COLOR_RGB2BGR)
                    save_gt_pred_pair(
                        img,
                        {"boxes": gt_canvas, "labels": batch["labels"][b][v]},
                        {"boxes": dets["boxes"][b][keep], "labels": labels[keep],
                         "scores": scores[keep]},
                        self.path_to_save / "eval_preds" / f"{len(preds):03d}.jpg",
                        self.label_to_name,
                    )
        return dist.gather_objects(preds), dist.gather_objects(gts)

    # ------------------------------------------------------------ checkpoint

    def _weights(self) -> Dict:
        model = {k: v.detach().cpu() for k, v in self.state.model.state_dict().items()}
        ema = self.state.ema
        return {"model": model,
                "ema": None if ema is None else {"module": {k: v.detach().cpu()
                                                            for k, v in ema.items()}}}

    def save_checkpoint(self, name: str, full: bool = False) -> None:
        """`<path_to_save>/<name>.pt`, written by rank 0 (atomically: a
        temporary file, then a rename); every process waits for it."""
        if self.is_main:
            tree = self._weights()
            if full:
                tree.update(optimizer=self.state.optimizer.state_dict(), step=self.state.step,
                            epoch=self.epoch, best_metric=self.best_metric,
                            epochs_no_improve=self.epochs_no_improve)
            path = self.path_to_save / f"{name}.pt"
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(tree, tmp)
            os.replace(tmp, path)
        if dist.world()[0] > 1:
            torch.distributed.barrier()

    def load_checkpoint(self, name: str) -> None:
        """Restore `<name>.pt`: the weights, and from `last` also the
        optimizer, step, epoch, best_metric and epochs_no_improve, so that
        train() goes on where the run stopped."""
        # on the CPU: load_state_dict copies to the model's device, and AdamW
        # keeps its step counts on the CPU
        tree = torch.load(self.path_to_save / f"{name}.pt", map_location="cpu",
                          weights_only=False)
        self.state.model.load_state_dict(tree["model"])
        if self.state.ema is not None and tree.get("ema") is not None:
            for k, v in tree["ema"]["module"].items():
                self.state.ema[k].copy_(v)
        if "optimizer" in tree:
            self.state.optimizer.load_state_dict(tree["optimizer"])
            self.state.step = int(tree["step"])
            self.epoch = int(tree["epoch"])
            self.best_metric = float(tree["best_metric"])
            self.epochs_no_improve = int(tree["epochs_no_improve"])

    def _save_and_maybe_stop(self, metrics: Dict[str, float]) -> None:
        """reference save_model (train.py:476-503): `model` on an improvement
        of mean(decision_metrics), then `last` (which records the decision)."""
        vals = [metrics.get(m, 0.0) for m in self.decision_metrics]
        score = float(np.mean(vals)) if vals else 0.0
        if score > self.best_metric:
            self.best_metric = score
            self.epochs_no_improve = 0
            self.save_checkpoint("model")
            logger.info(f"Saved best model (decision={score:.4f})")
        else:
            self.epochs_no_improve += 1
        self.save_checkpoint("last", full=True)

    # ------------------------------------------------------------ logging

    def _log_metrics(self, metrics: Dict[str, float]) -> None:
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in metrics.items() if not isinstance(v, dict)})
        try:
            from tabulate import tabulate

            rows = [(k, round(v, 4) if isinstance(v, float) else v)
                    for k, v in metrics.items() if not isinstance(v, dict)]
            logger.info("\n" + tabulate(rows, headers=["metric", "value"]))
        except ImportError:
            logger.info(str(metrics))

    @staticmethod
    def _write_csv(history: List[Dict], path: Path) -> None:
        if not history:
            return
        keys = sorted({k for h in history for k in h if not isinstance(h[k], dict)})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
            w.writeheader()
            for h in history:
                w.writerow({k: h.get(k) for k in keys})

