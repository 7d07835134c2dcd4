"""Train entry point of the PyTorch port:

    python -m custom_d_fine_tpu_torch.cli.train [--config config.yaml] [k=v ...]
    torchrun --nproc_per_node=N -m custom_d_fine_tpu_torch.cli.train [k=v ...]

Counterpart of custom_d_fine_tpu/cli/train.py (reference `make train` ->
python -m src.dl.train). Trains on the card (train.device=cpu and
train.dtype=float32 for the CPU). Under torchrun each process joins the
process group (parallel/dist.py:init_from_env) and trains on its share of
every batch. After training, or after a crash or an interrupt, the best
checkpoint is evaluated on val and test (extended metrics, plots); a crash
still exits 1.
"""

from __future__ import annotations

import argparse

import torch

from ..parallel.dist import init_from_env
from ..train.trainer import Trainer
from ..utils.config import load_config
from ..utils.logging import logger


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None, help="path to config.yaml")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    init_from_env(cfg["train"].get("device") or "cuda")
    try:
        return _train_and_evaluate(Trainer(cfg))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train_and_evaluate(trainer: Trainer):
    # reference train.py:668-677: an interrupt or crash mid-training still
    # falls through to best-model evaluation of whatever was saved so far.
    # A real crash must still fail the process (exit 1) after the fallback
    # eval, so automation can't mistake a garbage run for success.
    history = []
    crashed = None
    try:
        history = trainer.train()
    except KeyboardInterrupt:
        print("Interrupted by user — evaluating best checkpoint so far")
    except Exception as e:
        print(f"Training failed ({e!r}) — evaluating best checkpoint so far")
        crashed = e

    # final: reload best weights, extended eval on val+test (reference
    # train.py:678-745)
    try:
        trainer.load_checkpoint("model")
    except FileNotFoundError as e:
        print(f"best-checkpoint reload skipped: {e}")
    for split in ("val", "test"):
        if trainer.loader.datasets.get(split) is None:
            continue
        m = trainer.evaluate(split, extended=True)
        trainer._log_metrics({f"{split}_{k}": v for k, v in m.items()
                              if not isinstance(v, dict)})
        if trainer.is_main and getattr(trainer, "_last_validator", None) is not None:
            try:
                trainer._last_validator.save_plots(trainer.path_to_save / f"plots_{split}")
            except ImportError as e:  # matplotlib is optional
                logger.warning(f"plots of {split} skipped: {e}")
    if crashed is not None:
        raise SystemExit(1)
    return history


if __name__ == "__main__":
    main()
