"""The port's Trainer (custom_d_fine_tpu_torch/train/trainer.py) on the CPU,
on the synthetic YOLO set of tests/test_trainer_integration.py (16 JPEGs of
200x200 with one red rectangle each; 12 train, 4 val), with
tests/helpers.py:tiny_config() at 160x160 in float32:
  - the four behaviours of test_trainer_integration.py: one epoch with
    metrics and a checkpoint round trip, resume from `last` (model, EMA and
    optimizer state restored exactly), a multiscale epoch, and the training
    loss falling while the tiny model overfits; and early stopping;
  - get_preds_and_gt("val") against the JAX package's Trainer on the same
    weights (the JAX Trainer's EMA, conv kernels x sqrt(6) so that query
    selection does not tie, carried over by utils/weights.py), with the
    tolerances of tests/test_torch_serving.py: all top-300 scores at atol
    1e-4, labels and boxes (pixels, atol 1e-4 x 200) where a score stands
    more than 1e-4 from its neighbours; the ground truth exactly;
  - remap_obj365_head against the JAX package's copy.
"""

import cv2
import jax
import numpy as np
import pytest
import torch

from custom_d_fine_tpu.utils.torch_convert import remap_obj365_head as jremap
from custom_d_fine_tpu_torch.train.trainer import Trainer
from custom_d_fine_tpu_torch.utils.checkpoint import remap_obj365_head
from custom_d_fine_tpu_torch.utils.config import load_config
from custom_d_fine_tpu_torch.utils.weights import flax_to_torch

from helpers import tiny_config
from torch_threads import few_threads  # noqa: F401  (autouse)
from test_torch_train_step import port_config

TOL = 1e-4


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """tests/test_trainer_integration.py's set, drawn the same way."""
    root = tmp_path_factory.mktemp("trainds")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    names = []
    for i in range(16):
        img = rng.integers(0, 255, (200, 200, 3)).astype(np.uint8)
        x1, y1 = rng.integers(20, 100, 2)
        w, h = rng.integers(40, 80, 2)
        img[y1:y1 + h, x1:x1 + w] = [255, 32, 32]
        name = f"im{i}.jpg"
        cv2.imwrite(str(root / "images" / name), img)
        cx, cy = (x1 + w / 2) / 200, (y1 + h / 2) / 200
        (root / "labels" / f"im{i}.txt").write_text(
            f"0 {cx:.4f} {cy:.4f} {w / 200:.4f} {h / 200:.4f}\n")
        names.append(name)
    (root / "train.csv").write_text("\n".join(names[:12]) + "\n")
    (root / "val.csv").write_text("\n".join(names[12:]) + "\n")
    return root


def overrides(root, save, **kw):
    """test_trainer_integration.py's overrides, on the CPU in float32."""
    base = {"train.data_path": root, "train.path_to_save": save, "train.epochs": 1,
            "train.batch_size": 8, "train.num_workers": 2, "train.img_size": "[160,160]",
            "train.max_gt": 10, "train.label_to_name": "{0: obj}",
            "train.mosaic_augs.mosaic_prob": 0.3, "train.mosaic_augs.no_mosaic_epochs": 0,
            "train.dtype": "float32", "model_name": "n", "exp_name": "ittest"}
    base.update(kw)
    return [f"{k}={v}" for k, v in base.items()]


def port_trainer(ovr):
    return Trainer(load_config(overrides=ovr + ["train.device=cpu"]),
                   model_cfg_override=port_config(tiny_config()))


def test_trainer_one_epoch(dataset_root, tmp_path):
    trainer = port_trainer(overrides(dataset_root, tmp_path / "run"))
    history = trainer.train()
    assert len(history) == 1
    m = history[0]
    assert np.isfinite(m["train_loss"])
    assert "f1" in m and "mAP_50" in m
    assert all(torch.isfinite(p).all() for p in trainer.state.model.parameters())
    assert (tmp_path / "run" / "metrics.csv").exists()
    assert (tmp_path / "run" / "model.pt").exists()
    t = trainer.timings[0]
    assert t["steps"] == 1 and t["images"] == 8 and t["epoch_s"] >= t["train_s"] > 0

    trainer.load_checkpoint("last")  # checkpoint round trip
    m2 = trainer.evaluate("val")
    for k in ("f1", "mAP_50", "precision", "recall"):
        assert m2[k] == pytest.approx(m[k], abs=1e-9), k


def test_resume_from_last_checkpoint(dataset_root, tmp_path):
    """`last` carries the model, the EMA, the optimizer and the run's
    counters; a fresh Trainer that loads it holds them exactly."""
    ovr = overrides(dataset_root, tmp_path / "resume_run", **{
        "train.mosaic_augs.mosaic_prob": 0.0, "exp_name": "resume"})
    t1 = port_trainer(ovr)
    t1.train()
    assert t1.state.step > 0

    t2 = port_trainer(ovr)
    assert t2.state.step == 0
    t2.load_checkpoint("last")
    assert (t2.state.step, t2.epoch, t2.best_metric, t2.epochs_no_improve) == \
        (t1.state.step, t1.epoch, t1.best_metric, t1.epochs_no_improve)
    for a, b in ((t1.state.model.state_dict(), t2.state.model.state_dict()),
                 (t1.state.ema, t2.state.ema)):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    o1, o2 = t1.state.optimizer, t2.state.optimizer
    assert (o1.count, o1.mini_step) == (o2.count, o2.mini_step) and o1.count > 0
    s1, s2 = o1.adamw.state_dict()["state"], o2.adamw.state_dict()["state"]
    assert set(s1) == set(s2) and s1
    for i in s1:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s1[i][k], s2[i][k]), (i, k)
    assert any(float(s["exp_avg_sq"].abs().max()) > 0 for s in s2.values())
    assert t2.train() == []  # the run's one epoch is done

    # resumed into a longer run: its mosaic closes at epoch 1, before the
    # resumed epochs, and the background comes back at epoch 2
    t3 = port_trainer(ovr + ["train.epochs=2", "train.mosaic_augs.no_mosaic_epochs=2",
                             "train.mosaic_augs.mosaic_prob=0.5",
                             "train.ignore_background_epochs=1"])
    t3.load_checkpoint("last")
    ds = t3.loader.datasets["train"]
    assert ds.mosaic_prob == 0.5 and ds.ignore_background
    assert [m["epoch"] for m in t3.train()] == [2]
    assert ds.mosaic_prob == 0 and not ds.ignore_background


def test_trainer_multiscale_epoch(dataset_root, tmp_path):
    """multiscale_prob=1.0: every train batch is resized +-32 px; the eager
    port takes each canvas as it comes. batch_size 6 (12 train images)."""
    trainer = port_trainer(overrides(dataset_root, tmp_path / "ms_run", **{
        "train.batch_size": 6, "train.mosaic_augs.mosaic_prob": 0.0,
        "train.augs.multiscale_prob": 1.0, "train.augs.multiscale_deltas": "[-32,32]",
        "exp_name": "mstest"}))
    history = trainer.train()
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    assert trainer.timings[0]["steps"] == 2


def test_trainer_loss_descends_overfit(dataset_root, tmp_path):
    """Overfitting the tiny model on the 12 train images for 6 epochs must
    lower the training loss (a sign flip, a zeroed group or a broken
    schedule keeps the other tests green while the loss stalls)."""
    trainer = port_trainer(overrides(dataset_root, tmp_path / "run_descend", **{
        "train.epochs": 6, "train.augs.multiscale_prob": 0,
        "train.mosaic_augs.mosaic_prob": 0, "train.use_ema": "false",
        "exp_name": "descend"}))
    history = trainer.train()
    first, last = history[0]["train_loss"], history[-1]["train_loss"]
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first * 0.99, f"loss did not descend: {first:.3f} -> {last:.3f}"


def test_trainer_early_stopping(dataset_root, tmp_path):
    """decision_metrics f1 with conf_thresh above every score: the first
    epoch sets the best (0 > -1), the second does not improve, and
    early_stopping=1 ends the run there; `last` records the count."""
    trainer = port_trainer(overrides(dataset_root, tmp_path / "run_stop", **{
        "train.epochs": 4, "train.early_stopping": 1, "train.conf_thresh": 1.01,
        "train.decision_metrics": "[f1]", "train.mosaic_augs.mosaic_prob": 0,
        "exp_name": "stop"}))
    history = trainer.train()
    assert [m["epoch"] for m in history] == [1, 2]
    assert (trainer.best_metric, trainer.epochs_no_improve) == (0.0, 1)
    again = port_trainer(overrides(dataset_root, tmp_path / "run_stop"))
    again.load_checkpoint("last")
    assert (again.epoch, again.epochs_no_improve, again.best_metric) == (2, 1, 0.0)


def _robust(scores):
    gap = np.full(scores.shape, np.inf)
    d = np.abs(np.diff(scores))
    gap[:-1] = np.minimum(gap[:-1], d)
    gap[1:] = np.minimum(gap[1:], d)
    return gap > TOL


def test_get_preds_and_gt_matches_jax(dataset_root, tmp_path):
    from custom_d_fine_tpu.train.trainer import Trainer as JTrainer
    from custom_d_fine_tpu.utils.config import load_config as jload_config

    ovr = overrides(dataset_root, tmp_path / "jax_run", **{"train.batch_size": 4})
    jt = JTrainer(jload_config(overrides=ovr), model_cfg_override=tiny_config())
    ema = jax.device_get(jt.state.ema)
    ema["params"] = jax.tree_util.tree_map(lambda a: a * np.sqrt(6.0) if a.ndim == 4 else a,
                                           ema["params"])
    jt.state = jt.state._replace(ema=jax.device_put(ema, jt.repl))
    jpreds, jgts = jt.get_preds_and_gt("val", visualize=False)

    tt = port_trainer(overrides(dataset_root, tmp_path / "port_run", **{"train.batch_size": 4}))
    tt.state.model.load_state_dict(flax_to_torch(ema["params"], ema["batch_stats"]))
    for k, v in tt.state.model.state_dict().items():
        tt.state.ema[k].copy_(v)
    tpreds, tgts = tt.get_preds_and_gt("val", visualize=False)

    assert len(tpreds) == len(jpreds) == 4 and len(tgts) == len(jgts) == 4
    for tg, jg in zip(tgts, jgts):
        np.testing.assert_array_equal(tg["labels"], jg["labels"])
        np.testing.assert_array_equal(tg["boxes"], jg["boxes"])
    n_robust = 0
    for tp, jp in zip(tpreds, jpreds):
        np.testing.assert_allclose(tp["all_scores"], jp["all_scores"], atol=TOL)
        keep = _robust(tp["all_scores"]) & _robust(jp["all_scores"])
        n_robust += int(keep.sum())
        np.testing.assert_array_equal(tp["all_labels"][keep], jp["all_labels"][keep])
        np.testing.assert_allclose(tp["all_boxes"][keep], jp["all_boxes"][keep],
                                   atol=TOL * 200)
    assert n_robust >= 20


def test_remap_obj365_head_matches_jax():
    """An Objects365-shaped head state (366 score rows, 367 embedding rows)
    onto 80 classes: the same rows kept, the embedding dropped, the rest
    untouched. The port's copy takes tensors as well as arrays."""
    rng = np.random.default_rng(11)
    pre = {"decoder.denoising_class_embed.weight": rng.normal(size=(367, 32)),
           "decoder.enc_score_head.weight": rng.normal(size=(366, 32)),
           "decoder.enc_score_head.bias": rng.normal(size=(366,)),
           "decoder.dec_score_head.3.bias": rng.normal(size=(366,)),
           "decoder.query_pos_head.layers.0.weight": rng.normal(size=(32, 4)),
           "decoder.up": np.asarray(0.5)}
    pre = {k: np.asarray(v, np.float32) for k, v in pre.items()}
    want = jremap(pre, num_classes=80)
    for state in (pre, {k: torch.from_numpy(v) for k, v in pre.items()}):
        got = remap_obj365_head(state, num_classes=80)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    assert "decoder.denoising_class_embed.weight" not in want
