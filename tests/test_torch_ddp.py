"""Data-parallel training of the port (parallel/dist.py) on the CPU: two
processes on the gloo backend, each stepping on its half of a global batch,
against one process stepping on the whole global batch, for 2 updates of
tests/helpers.py:tiny_config() at 160x160 (global batch 4 with 3, 1, 4 and 2
boxes, EMA on, conv kernels x sqrt(6) so that query selection does not tie).

The model runs in float64 (the criterion in float32, as always). In float32
the tiny backbone's backward is ill-conditioned (a ReLU input within f32
rounding of zero; tests/test_torch_train_step.py): BatchNorm statistics or
a convolution summed in another order, even another thread count for the
1-process run alone, move its gradients by ~1e-2 after one update, which
would hide a wrong invariant as well as a right one.

What must hold (parallel/dist.py's invariant), tolerances from the
measured float64 differences:
  - the synced BatchNorm alone, on a random [4,8,5,5] input: output, input
    gradient and running statistics equal the 1-process BatchNorm's on the
    global input (atol 1e-10; measured 1.3e-15);
  - every loss term summed over the two processes, and grad_norm, which
    both processes report for the global batch, equal the 1-process ones
    (rtol 1e-5, atol 1e-9; measured 1.4e-7 before the first update and
    1.1e-6 after it, the criterion's float32);
  - the gradients (summed over the processes), relative L2 over the
    backbone and over the rest: 1e-7 before the first update (measured
    4.7e-9) and 2e-5 after it (measured 2.9e-6);
  - parameters and EMA after 2 updates within 0.01 of the summed learning
    rate (measured 7.8e-4), BatchNorm running statistics at rtol 1e-5,
    atol 1e-6 (measured 3.6e-7);
  - the two processes hold bitwise equal gradients, parameters and EMA;
  - the loader gives each process its stride of the seeded order by itself
    (no rank passed), gather_objects concatenates in rank order, and
    check_replicas passes equal tensors and raises on every process when
    one process's tensors differ.
Each process joins under its own time limit and fails the test, not hangs
it, when the limit runs out.
"""

import dataclasses
import multiprocessing as mp
import socket

import cv2
import numpy as np
import pytest
import torch

from custom_d_fine_tpu_torch.configs import registry as treg
from custom_d_fine_tpu_torch.data.loader import Loader
from custom_d_fine_tpu_torch.models.dfine import build_model
from custom_d_fine_tpu_torch.models.layers import BatchNorm
from custom_d_fine_tpu_torch.parallel import dist
from custom_d_fine_tpu_torch.train.criterion import DFINECriterion
from custom_d_fine_tpu_torch.train.optim import Optimizer
from custom_d_fine_tpu_torch.train.train_step import create_train_state, make_train_step

from helpers import tiny_config
from torch_threads import few_threads  # noqa: F401  (autouse)

IMG, B_GLOBAL, NC, WORLD = 160, 4, 4, 2
JOIN_S = 240
LR = dict(base_lr=2.5e-4, backbone_lr=6e-5, total_steps=100)


def _port_config():
    d = dataclasses.asdict(tiny_config())
    return treg.ModelConfig(
        name=d["name"], backbone=treg.BackboneConfig(**d["backbone"]),
        encoder=treg.EncoderConfig(**d["encoder"]), decoder=treg.DecoderConfig(**d["decoder"]),
        criterion=treg.CriterionConfig(**d["criterion"]),
        matcher=treg.MatcherConfig(**d["matcher"]), max_gt=d["max_gt"],
        dn_max_gt=d["dn_max_gt"])


def _global_batch(cfg):
    rng = np.random.default_rng(5)
    G = cfg.max_gt
    valid = np.zeros((B_GLOBAL, G), bool)
    for b, n in enumerate((3, 1, 4, 2)):  # unequal box counts: num_boxes differs by rank
        valid[b, :n] = True
    return {"images": rng.integers(0, 256, (B_GLOBAL, IMG, IMG, 3)).astype(np.uint8),
            "labels": rng.integers(0, NC, (B_GLOBAL, G)).astype(np.int64),
            "boxes": np.concatenate([rng.uniform(0.3, 0.7, (B_GLOBAL, G, 2)),
                                     rng.uniform(0.1, 0.3, (B_GLOBAL, G, 2))],
                                    -1).astype(np.float32),
            "valid": valid}


def _train(cfg, batch):
    """2 updates on `batch` (this process's rows); the end state as numpy."""
    torch.manual_seed(0)
    model = build_model(cfg, num_classes=NC, seed=0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(np.sqrt(6.0))
    model = model.double().train()
    state = create_train_state(model, Optimizer(model, cfg, **LR), use_ema=True)
    step = make_train_step(DFINECriterion(cfg.criterion, cfg.matcher, num_classes=NC))
    gen = torch.Generator().manual_seed(11)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["images"] = tb["images"].double() / 255.0
    tb["boxes"] = tb["boxes"].double()
    metrics, grads, lrs = [], [], []
    for _ in range(2):
        lrs.append(state.optimizer.schedules[0](state.optimizer.count))
        state, m = step(state, tb, gen)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({n: p.grad.detach().clone().numpy() for n, p in model.named_parameters()})
    return {"metrics": metrics, "grads": grads, "lrs": lrs,
            "state": {k: v.detach().clone().numpy() for k, v in model.state_dict().items()},
            "ema": {k: v.clone().numpy() for k, v in state.ema.items()}}


def _batch_norm(rows):
    """A train-mode BatchNorm on `rows` of a fixed random [4,8,5,5] input:
    its output, the input's gradient and the running statistics."""
    g = torch.Generator().manual_seed(2)
    x = (torch.randn(4, 8, 5, 5, generator=g) * 3 + 1).double()
    w = torch.randn(4, 8, 5, 5, generator=g).double()
    bn = BatchNorm(8).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(8, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(8, generator=g))
    xr = x[rows].clone().requires_grad_()
    y = bn(xr)
    (y * w[rows]).sum().backward()
    return {"y": y.detach().numpy(), "dx": xr.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def _worker(rank, port, cfg, batch, data_root, queue):
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=WORLD, rank=rank)
    try:
        half = B_GLOBAL // WORLD
        rows = slice(rank * half, (rank + 1) * half)
        out = _train(cfg, {k: v[rows] for k, v in batch.items()})
        out["bn"] = _batch_norm(rows)
        out["gathered"] = dist.gather_objects([f"r{rank}a", f"r{rank}b"])
        dist.check_replicas([torch.ones(3), torch.arange(4)], "equal tensors")
        try:
            dist.check_replicas([torch.ones(3), torch.tensor([float(rank)])], "rank tensors")
            out["replicas_differ"] = None
        except RuntimeError as e:
            out["replicas_differ"] = str(e)
        out["order"] = Loader(data_root, (IMG, IMG), batch_size=2,
                              num_workers=1).epoch_iterator("train", epoch=1).order
        queue.put((rank, out))
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddpds")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    names = [f"im{i}.png" for i in range(7)]
    for n in names:
        cv2.imwrite(str(root / "images" / n), np.full((32, 32, 3), 9, np.uint8))
    (root / "train.csv").write_text("\n".join(names) + "\n")
    return root


def _rel_l2(got, want, keys):
    num = sum(((got[k] - want[k]).astype(np.float64) ** 2).sum() for k in keys)
    return float(np.sqrt(num / sum((want[k].astype(np.float64) ** 2).sum() for k in keys)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_step_equals_one_process_on_the_global_batch(data_root):
    cfg = _port_config()
    batch = _global_batch(cfg)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, cfg, batch, data_root, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=JOIN_S) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]

    bn = _batch_norm(slice(None))
    half = B_GLOBAL // WORLD
    for rank in range(WORLD):
        got = results[rank]["bn"]
        rows = slice(rank * half, (rank + 1) * half)
        for k in ("y", "dx"):
            np.testing.assert_allclose(got[k], bn[k][rows], rtol=0, atol=1e-10, err_msg=k)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k], bn[k], rtol=0, atol=1e-10, err_msg=k)

    want = _train(cfg, batch)  # one process, the whole global batch
    got0, got1 = results[0], results[1]
    for i in range(2):
        for k, v in want["metrics"][i].items():
            if k == "grad_norm":
                assert got0["metrics"][i][k] == got1["metrics"][i][k]
                total = got0["metrics"][i][k]
            else:
                total = got0["metrics"][i][k] + got1["metrics"][i][k]
            np.testing.assert_allclose(total, v, rtol=1e-5, atol=1e-9, err_msg=(i, k))
        for k in want["grads"][i]:
            np.testing.assert_array_equal(got0["grads"][i][k], got1["grads"][i][k], err_msg=k)
        for part in ("backbone", "rest"):
            keys = [k for k in want["grads"][i] if k.startswith("backbone") == (part == "backbone")]
            assert _rel_l2(got0["grads"][i], want["grads"][i], keys) <= (1e-7, 2e-5)[i], (i, part)

    lr_sum = sum(want["lrs"])
    for part in ("state", "ema"):
        for k, v in want[part].items():
            np.testing.assert_array_equal(got0[part][k], got1[part][k], err_msg=(part, k))
            tol = dict(rtol=1e-5, atol=1e-6) if "running" in k else dict(rtol=0, atol=0.01 * lr_sum)
            np.testing.assert_allclose(got0[part][k], v, err_msg=(part, k), **tol)
    assert any("running_var" in k and not np.allclose(v, 1.0) for k, v in want["state"].items())

    assert got0["gathered"] == got1["gathered"] == ["r0a", "r0b", "r1a", "r1b"]
    assert got0["replicas_differ"] == got1["replicas_differ"] == \
        "rank tensors differ between process 0 and processes [1]"
    loader = Loader(data_root, (IMG, IMG), batch_size=2, num_workers=1)
    for rank in range(WORLD):
        want_order = loader.epoch_iterator("train", epoch=1, process_index=rank,
                                           process_count=WORLD).order
        np.testing.assert_array_equal(results[rank]["order"], want_order)
        assert len(want_order) == 4  # 7 images wrap-padded to 8
