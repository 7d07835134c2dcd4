"""Host-side batched assignment and GO union (numpy + scipy), the port's copy
of custom_d_fine_tpu/ops/hungarian.py (host_solve :17, host_go_union :32).

The JAX package solves on the device with its own LAPJV (ops/lapjv.py) only
because its TPU runtime has no host callbacks; the port copies the costs to
the host once per step and solves them here, as the reference does
(src/d_fine/matcher.py:239-247; GO union dfine_criterion.py:570-591).
Valid GT columns are a prefix of each image's padded columns.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def host_solve(costs: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """costs [S, B, Q, G], n_valid [B] -> assign [S, B, G] (query per GT, -1
    for invalid GT slots). Exact (Jonker-Volgenant); ties may pick another
    equally optimal matching than another solver."""
    S, B, Q, G = costs.shape
    out = np.full((S, B, G), -1, np.int64)
    costs = np.nan_to_num(costs, nan=1.0)
    for b in range(B):
        n = int(n_valid[b])
        if n == 0:
            continue
        for s in range(S):
            rows, cols = linear_sum_assignment(costs[s, b, :, :n])
            out[s, b, cols] = rows
    return out


def host_go_union(assign: np.ndarray, n_valid: np.ndarray, num_queries: int):
    """GO union: per query keep the GT it was matched to most often across the
    output sets, ties to the smallest GT index. Returns (best_g [B, Q],
    valid_q [B, Q])."""
    S, B, G = assign.shape
    best_g = np.zeros((B, num_queries), np.int64)
    valid_q = np.zeros((B, num_queries), bool)
    for b in range(B):
        n = int(n_valid[b])
        pairs = [(int(assign[s, b, g]), g) for s in range(S) for g in range(n)
                 if assign[s, b, g] >= 0]
        if not pairs:
            continue
        uniq, counts = np.unique(np.asarray(pairs, np.int64), axis=0, return_counts=True)
        for q, g in uniq[np.argsort(-counts, kind="stable")]:
            if not valid_q[b, q]:
                valid_q[b, q] = True
                best_g[b, q] = g
    return best_g, valid_q
