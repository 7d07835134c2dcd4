"""The training check's reference follows the program's discrete choices.

Two choices in a D-FINE step are discrete: the decoder's query selection
(the top 300 of 8,400 encoder scores, `topk` with k = num_queries) and the
Hungarian matching (`host_solve`, on the host). With random weights the
scores and costs lie close together, so rounding flips a few of them, and a
flip changes the loss and every gradient by more than any precision does.
So set-up records the program's choices in its checked steps (`Recorder`:
a TorchDispatchMode on `aten.topk`, and the matcher module's `host_solve`
wrapped while the checked steps run), and the reference makes the same
choices (`Replayer`). Each choice is held against the best one, as the share
of the way from the best choice to a choice at random that the program's
lies, pooled over every row and output set of the checked steps:
- `matching_excess` = (cost of the program's matching - the optimal cost) /
  (the expected cost of a random matching - the optimal cost), under the
  reference's own costs;
- `selection_excess` = (sum of the top-k scores - sum of the scores at the
  program's k queries) / (the top-k sum - k x the mean score), under the
  scores the program's selection took as its input (recorded with it: the
  reference's own scores follow the backbone and encoder, whose bf16
  rounding a random-weight network amplifies, PERF.md), so it reads 0 for
  an exact top-k and about 1 or more for a wrong one;
- `selection_excess.ref`, the same under the reference's own scores (read).
Near ties that rounding flips cost little; a wrong choice reads near 1."""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _Topk(TorchDispatchMode):
    def __init__(self, k: int, on_call):
        super().__init__()
        self.k, self.on_call = k, on_call

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.topk.default and len(args) > 1 and args[1] == self.k:
            return self.on_call(func, args, kwargs)
        return func(*args, **kwargs)


class Recorder:
    """with Recorder(k, matcher_module) as rec: <steps>; rec.selections and
    rec.assignments hold the program's choices in order."""

    def __init__(self, k: int, matcher_module):
        self.k, self.module = k, matcher_module
        self.selections: List[torch.Tensor] = []
        self.scores: List[torch.Tensor] = []  # each selection's input, on the host
        self.assignments: List[np.ndarray] = []

    def _topk(self, func, args, kwargs):
        out = func(*args, **kwargs)
        self.selections.append(out[1].detach().clone())
        self.scores.append(args[0].detach().double().cpu())
        return out

    def selection_excess(self) -> float:
        """selection_excess under the recorded inputs of the selections (the
        scores are taken over their last dimension, as the decoder's top-k
        takes them)."""
        num = den = 0.0
        for x, idx in zip(self.scores, self.selections):
            best = x.topk(idx.shape[-1], dim=-1).values.sum(-1)
            picked = x.gather(-1, idx.cpu()).sum(-1)
            num += float((best - picked).sum())
            den += float((best - x.mean(-1) * idx.shape[-1]).sum())
        return num / den if den > 0 else 0.0

    @contextlib.contextmanager
    def recording(self):
        solve = self.module.host_solve

        def recorded(costs, n_valid):
            assign = solve(costs, n_valid)
            self.assignments.append(np.array(assign, copy=True))
            return assign

        self.module.host_solve = recorded
        try:
            with _Topk(self.k, self._topk):
                yield self
        finally:
            self.module.host_solve = solve


class Replayer:
    """Make the recorded choices in the reference, in the same order, and
    measure how far they are from the reference's own."""

    def __init__(self, rec: Recorder, matcher_module):
        self.sel, self.assign = list(rec.selections), list(rec.assignments)
        self.k, self.module = rec.k, matcher_module
        self.sel_excess = [0.0, 0.0]    # pooled numerator, denominator
        self.match_excess = [0.0, 0.0]
        self.mismatched = 0  # choices the program made on other shapes, or never made

    def _topk(self, func, args, kwargs):
        own = func(*args, **kwargs)
        idx = self.sel.pop(0).to(own[1].device) if self.sel else None
        if idx is None or idx.shape != own[1].shape:
            self.mismatched += 1
            return own
        x, dim = args[0], (args[2] if len(args) > 2 else kwargs.get("dim", -1))
        picked = torch.gather(x, dim, idx)
        best = own[0].double().sum(dim)
        rand = x.double().mean(dim) * idx.shape[dim]
        self.sel_excess[0] += float((best - picked.double().sum(dim)).sum())
        self.sel_excess[1] += float((best - rand).sum())
        return picked, idx

    def _solve(self, solve):
        def replayed(costs, n_valid):
            prog = self.assign.pop(0) if self.assign else None
            best = solve(costs, n_valid)
            if prog is None or prog.shape != best.shape:
                self.mismatched += 1
                return best
            c = np.nan_to_num(np.asarray(costs, np.float64), nan=1.0)
            S, B = prog.shape[:2]
            for s in range(S):
                for b in range(B):
                    n = int(n_valid[b])
                    g = np.arange(n)
                    c_best = c[s, b, best[s, b, :n], g].sum()
                    self.match_excess[0] += c[s, b, prog[s, b, :n], g].sum() - c_best
                    self.match_excess[1] += c[s, b, :, :n].mean(0).sum() - c_best
            return prog

        return replayed

    @contextlib.contextmanager
    def replaying(self):
        solve = self.module.host_solve
        self.module.host_solve = self._solve(solve)
        try:
            with _Topk(self.k, self._topk):
                yield self
        finally:
            self.module.host_solve = solve

    def readings(self) -> Dict[str, Any]:
        def share(pair):
            return pair[0] / pair[1] if pair[1] > 0 else 0.0

        return {"selection_excess.ref": share(self.sel_excess),
                "matching_excess": share(self.match_excess),
                "choices_mismatched": float(self.mismatched + len(self.sel) + len(self.assign))}
