"""Runner of traffic kind "train": the port's training step,
`step(state, batch, generator)` from `build_training`, on a pool of batches
made on the card, cycled.

Set-up builds the one training state, drives it through the mix's first
`checked_steps` steps (on distinct batches) and records what `correct`
compares: each step's loss as the step returned it, every parameter's first
gradient as AdamW received it (its first moment after one step over
1 - beta1), the change of every parameter and of its EMA over those
steps, what step 1's forward produced at a few points (FirstForward), and
the program's query selections and matchings (replay.py). Then `warmup_steps` more, and the same state trains in the window.
End-to-end metric: train_img_per_s, the images of every step completed in
the window over the window's seconds (closed by a synchronize)."""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import torch

from .. import work
from ..capture import FirstCalls
from ..generate import train_pool
from ..reference.dfine.train import matcher as ref_matcher
from ..replay import Recorder, Replayer
from ..harness import Check, profile_window, select_checks
from ..reference.dfine.train.criterion import DFINECriterion
from ..reference.dfine.train.optim import Optimizer
from ..reference.dfine.train.train_step import RefState, train_step
from ..weights import make_weights
from .common import (Phases, leaf_gaps, mask_size, model_config, quantile, reference_model,
                     strict_fp32)

LEAF_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median leaf's


def first_grads(optimizer: torch.optim.Optimizer, params: Dict[str, torch.Tensor]
                ) -> Dict[str, float]:
    """Per parameter in the optimizer: the norm of the gradient it received
    at its first step, exp_avg / (1 - beta1)."""
    names, norms = [], []
    for group in optimizer.param_groups:
        beta1 = group["betas"][0]
        ids = {id(p) for p in group["params"]}
        for k, p in params.items():
            if id(p) in ids and p in optimizer.state:
                names.append(k)
                norms.append(torch.linalg.vector_norm(optimizer.state[p]["exp_avg"].float())
                             / (1.0 - beta1))
    return dict(zip(names, torch.stack(norms).tolist())) if norms else {}


def loss_sum(metrics: Dict[str, torch.Tensor], dn: bool, mask: bool) -> float:
    """The sum of a step's loss terms of the denoising sets (names with
    `_dn_`) or of the matched sets (without), that are mask terms (names
    that start `loss_mask_`) or not; NaN where there is none."""
    terms = [v for k, v in metrics.items() if k.startswith("loss_")
             and ("_dn_" in k) == dn and k.startswith("loss_mask_") == mask]
    return float(torch.stack([t.float() for t in terms]).sum()) if terms else math.nan


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|; inf where the program's a is not finite."""
    return abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf


class FirstForward:
    """with FirstForward(model) as first: <steps>; first.value holds, in f32
    on the host, what the model's first forward inside the block produced at
    each point (forward hooks, from outside the model): the stem, the first
    two backbone stages, and of the decoder the encoder's scores at the
    selected queries, the first layer's and the final layer's logits and the
    final boxes, and with the mask head the mask features (`mask_feat`, the
    MaskDecoder's output, before the queries' matmul) and the final layer's
    mask logits; first.inputs["mask_feat"] holds the PAN levels that the
    MaskDecoder took. (Deeper points were read once; PERF.md.)"""

    def __init__(self, model: torch.nn.Module):
        self.value: Dict[str, torch.Tensor] = {}
        self.inputs: Dict[str, List[torch.Tensor]] = {}
        stages = model.backbone.stages
        self.points = {"stem": model.backbone.stem, "stage0": stages[0], "stage1": stages[1],
                       "model": model}
        if getattr(model.decoder, "mask_decoder", None) is not None:
            self.points["mask_feat"] = model.decoder.mask_decoder

    def _keep(self, name, t):
        if name not in self.value:
            self.value[name] = t.detach().float().cpu()

    def _hook(self, name):
        def hook(_mod, inp, out):
            if name == "mask_feat" and name not in self.inputs:
                self.inputs[name] = [f.detach().float().cpu() for f in inp[0]]
            if name == "model":
                self._keep("enc_logit", out["enc_aux_outputs"][0]["pred_logits"])
                self._keep("pre_logit", out["pre_outputs"]["pred_logits"])
                self._keep("logit", out["pred_logits"])
                self._keep("box", out["pred_boxes"])
                if out.get("pred_masks") is not None:
                    self._keep("mask", out["pred_masks"])
            else:
                self._keep(name, out)
        return hook

    def __enter__(self):
        self.handles = [m.register_forward_hook(self._hook(n)) for n, m in self.points.items()]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def output_gap(prog: Optional[torch.Tensor], ref: torch.Tensor) -> float:
    """||program - reference|| / ||reference|| over the whole tensor; inf
    where the program gave none or another shape."""
    if prog is None or prog.shape != ref.shape:
        return math.inf
    return float(torch.linalg.vector_norm((prog - ref).double())
                 / torch.linalg.vector_norm(ref.double()).clamp(min=1e-30))


def change_norms(now: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    names = list(before)
    vals = torch.stack([torch.linalg.vector_norm(now[k].detach().float() - before[k].float())
                        for k in names])
    return dict(zip(names, vals.tolist()))


class Train:
    def __init__(self, cell, seed: int, device, step_wrapper=None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.mix, self.config = cell.traffic, cell.config
        self.step_wrapper = step_wrapper  # tests: a fault planted under the timed path
        self.data: Dict[str, Any] = {}
        self.count_flops_in_check = False
        self.mask_size = mask_size(self.config, self.mix["img"]) if self.mix.get("masks") else 0

    def _opt_kw(self) -> Dict[str, Any]:
        return {k: self.mix[k] for k in ("base_lr", "backbone_lr", "total_steps")}

    def build(self):
        """The program: the port's build_training of the configuration's
        model (common.model_config) with the run's weights."""
        from custom_d_fine_tpu_torch.train.train_step import build_training

        nc = self.config["num_classes"]
        cfg = model_config(self.config)
        weights = make_weights(cfg, nc, self.seed, self.device, self.mix["img"])
        return build_training(cfg, nc, device=self.device, bf16=self.mix["bf16"],
                              state_dict=weights, **self._opt_kw())

    def matcher_module(self):
        """The module whose `host_solve` the program's matcher calls."""
        import custom_d_fine_tpu_torch.train.matcher as m

        return m

    def setup(self, tmpdir: Optional[str] = None) -> None:
        phase = Phases("train")
        self.pool = train_pool(self.mix, self.seed, self.config["num_classes"], self.device,
                               self.mask_size)
        phase("pool")
        step, self.state = self.build()
        phase("build")
        self.step = self.step_wrapper(step) if self.step_wrapper else step
        self.gen = torch.Generator().manual_seed(self.seed)
        params = dict(self.state.model.named_parameters())
        p0 = {k: v.detach().clone() for k, v in params.items()}
        e0 = {k: self.state.ema[k].clone() for k in params}
        losses = []
        self.recorder = Recorder(model_config(self.config).decoder.num_queries,
                                 self.matcher_module())
        with self.recorder.recording(), FirstForward(self.state.model) as first:
            for s in range(self.mix["checked_steps"]):
                self.state, m = self.step(self.state, self.pool[s], self.gen)
                losses.append(float(m["total_loss"]))
                if s == 0:
                    self.data["grad1"] = first_grads(self.state.optimizer.adamw, params)
                    self.data["loss1"] = {(dn, mask): loss_sum(m, dn, mask)
                                          for dn in (False, True) for mask in (False, True)}
        self.data["losses"] = losses
        self.data["outputs1"], self.data["inputs1"] = first.value, first.inputs
        self.data["change"] = change_norms(params, p0)
        self.data["ema_change"] = change_norms(self.state.ema, e0)
        del p0, e0
        phase("checked steps")
        self.next = self.mix["checked_steps"]
        for _ in range(self.mix["warmup_steps"]):
            self._one()
        self._sync()
        phase("warm-up")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _one(self) -> None:
        self.state, _ = self.step(self.state, self.pool[self.next % len(self.pool)], self.gen)
        self.next += 1

    def window(self, seconds: float) -> Dict[str, Any]:
        done = failed = 0
        self._sync()
        t_open = time.perf_counter()
        deadline = t_open + seconds
        while time.perf_counter() < deadline:
            try:
                self._one()
                done += 1
            except Exception as e:  # noqa: BLE001 - a failed step is counted, not fatal
                failed += 1
                self.data.setdefault("errors", []).append(repr(e)[:300])
        self._sync()
        window = time.perf_counter() - t_open
        imgs = done * self.mix["batch"] * self.mix["processes"]
        self.data["window_s"], self.data["unit_s"] = window, window / max(done, 1)
        metrics = {"train_img_per_s": {"value": imgs / window, "unit": "img/s"}} if done else {}
        return {"attempted": done + failed, "failed": failed, "metrics": metrics}

    def traced(self) -> None:
        n = self.mix["trace_steps"]

        def steps() -> int:
            for _ in range(n):
                self._one()
            return n

        self.data["profile"] = profile_window(torch, steps, self.device.index or 0)
        with FirstCalls(("msda_fwd", "msda_bwd")) as cap:
            self._one()
        self._sync()
        kernels = {}
        for op, fn in (("msda_fwd", work.msda_work), ("msda_bwd", work.msda_bwd_work)):
            if op in cap.args:
                a = cap.args[op]
                value, shapes, loc, attn, points = a[0], a[1], a[3], a[4], a[-1]
                b, f = fn(value, list(zip(shapes[0::2], shapes[1::2])), loc, attn, points)
                kernels[op] = {"bytes": b, "flops": f, "peak": work.PEAK_F32}
        self.data["kernels"] = kernels
        self.count_flops_in_check = True  # on the reference's first step

    def release(self) -> None:
        del self.state, self.step, self.pool

    # ------------------------------------------------------------ reference

    def check(self, limits: Dict[str, float]) -> List[Check]:
        with strict_fp32():
            self.data["readings"] = self.readings()
        return select_checks(self.data["readings"], limits)

    def readings(self) -> Dict[str, float]:
        """The reference follows the first `checked_steps` steps from the
        same weights, batches and denoising generator in f32 (TF32 off),
        making the program's query selections and matchings (replay.py; the
        readings selection_excess, matching_excess and choices_mismatched
        hold those choices against the best ones):
        - loss_gap.<n>: |loss - reference loss| / |reference loss| of step n;
        - <point>_gap.1: ||program - reference|| / ||reference|| of what step
          1's forward produced at each point of FirstForward (stem, stage0,
          stage1, enc_logit, pre_logit, logit, box; the decoder's queries are
          the same on both sides by the replay);
        - dn_loss_gap.1: as loss_gap.1, of the first step's denoising terms but
          the mask terms, whose queries are matched to their targets by
          construction: the Hungarian matcher's choices, which flip on
          rounding when two costs are near, do not reach them;
        - with the mask head, mask_loss_gap.1: as loss_gap.1, of the first
          step's mask terms (loss_mask_*) of the matched sets (final and
          aux), and dn_mask_loss_gap.1, of its mask terms of the denoising
          sets; mask_feat_gap.1 and mask_gap.1 are FirstForward's points
          `mask_feat` and `mask`; mask_feat_local_gap.1, as <point>_gap.1, of
          the program's mask features against the reference's MaskDecoder
          (at the starting weights) run on the very PAN levels the program's
          took: the head's own rounding, which the gaps upstream of it do not
          drown;
        - grad_gap, change_gap, ema_gap: each leaf's gap of norms (the first
          gradient as AdamW received it; each parameter's change over the
          steps; its EMA's change) over the larger of the reference leaf's
          norm and the median leaf's, taken at the worst leaf, and with
          `.p90` and `.median` at those quantiles of the leaves.
        Leaves whose reference gradient is under LEAF_FLOOR of the median
        leaf's are left out: they move by round-off alone. A parameter the
        program's optimizer never stepped reads a norm of 0."""
        d = self.data
        nc = self.config["num_classes"]
        cfg = model_config(self.config)
        model = reference_model(self.config, self.seed, self.device, self.mix["img"]).train()
        criterion = DFINECriterion(cfg.criterion, cfg.matcher, num_classes=nc)
        optimizer = Optimizer(model, cfg, **self._opt_kw())
        state = RefState(model, optimizer, {k: v.detach().clone()
                                            for k, v in model.state_dict().items()})
        pool = train_pool(self.mix, self.seed, nc, self.device, self.mask_size)
        gen = torch.Generator().manual_seed(self.seed)
        params = dict(model.named_parameters())
        p0 = {k: v.detach().clone() for k, v in params.items()}
        e0 = {k: state.ema[k].clone() for k in params}
        local = None
        if "mask_feat" in d["inputs1"]:
            with torch.no_grad():
                feats = [f.to(self.device) for f in d["inputs1"]["mask_feat"]]
                local = model.decoder.mask_decoder(feats).float().cpu()
            del feats
        losses, grad1 = [], {}
        replay = Replayer(self.recorder, ref_matcher)
        with replay.replaying(), FirstForward(model) as first:
            for s in range(self.mix["checked_steps"]):
                if s == 0 and self.count_flops_in_check:
                    out = self._counted_step(state, criterion, pool[s], gen)
                else:
                    out = train_step(state, criterion, pool[s], gen)
                losses.append(float(out["total_loss"]))
                if s == 0:
                    grad1 = first_grads(optimizer.adamw, params)
                    ref1 = {key: loss_sum(out, *key) for key in d["loss1"]}
        change = change_norms(params, p0)
        ema_change = change_norms(state.ema, e0)
        med = quantile(grad1.values(), 0.5)
        leaves = [k for k, v in grad1.items() if v >= LEAF_FLOOR * med]
        d["leaves_left_out"] = sorted(set(grad1) - set(leaves))
        out: Dict[str, float] = dict(replay.readings())
        out["selection_excess"] = self.recorder.selection_excess()
        for i, (a, b) in enumerate(zip(d["losses"], losses), 1):
            out[f"loss_gap.{i}"] = rel_gap(a, b)
        for k, ref in first.value.items():
            out[f"{k}_gap.1"] = output_gap(d["outputs1"].get(k), ref)
        out["dn_loss_gap.1"] = rel_gap(d["loss1"][True, False], ref1[True, False])
        if self.mask_size:
            out["mask_loss_gap.1"] = rel_gap(d["loss1"][False, True], ref1[False, True])
            out["dn_mask_loss_gap.1"] = rel_gap(d["loss1"][True, True], ref1[True, True])
        if local is not None:
            out["mask_feat_local_gap.1"] = output_gap(d["outputs1"].get("mask_feat"), local)
        for name, prog, ref in (("grad_gap", d["grad1"], grad1), ("change_gap", d["change"], change),
                                ("ema_gap", d["ema_change"], ema_change)):
            gaps = leaf_gaps(prog, ref, leaves)
            worst = max(gaps, key=gaps.get)
            out[name] = gaps[worst]
            out[f"{name}.p90"] = quantile(gaps.values(), 0.9)
            out[f"{name}.median"] = quantile(gaps.values(), 0.5)
            d.setdefault("worst_leaf", {})[name] = worst
        return out

    def _counted_step(self, state, criterion, batch, gen):
        """The reference's first step under FlopCounterMode: the least
        device seconds of a step at the cell's shapes. The model's forward
        and every backward run under bf16 autocast in the port, so they count
        at the bf16 peak (with `bf16` off, at TF32 for convolutions and f32
        for the rest); the criterion's forward at the f32 peak; the MSDA
        forward and backward calls at the f32 peak, from the first call's
        captured inputs, once for each decoder layer (`num_layers` of each
        a step: 4 at D-FINE-M, 6 at D-FINE-X)."""
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            out = train_step(state, criterion, batch, gen)
        counts = fc.get_flop_counts()
        total = sum(counts.get("Global", {}).values())
        model = sum(counts.get("DFINE", {}).values())
        rest = total - model
        ker = self.data.get("kernels", {})
        calls = model_config(self.config).decoder.num_layers
        msda = calls * sum(ker.get(k, {}).get("flops", 0.0) for k in ("msda_fwd", "msda_bwd"))
        per_proc = (model / work.PEAK_BF16 + rest / work.PEAK_F32 + msda / work.PEAK_F32)
        self.data["flops"] = {"total": total, "model": model, "rest": rest, "msda": msda}
        self.data["least_s"] = per_proc
        return out


def make(cell, seed: int, device, **kw) -> Train:
    return Train(cell, seed, device, **kw)
