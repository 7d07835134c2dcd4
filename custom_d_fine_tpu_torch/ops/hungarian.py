"""Host-side batched assignment and GO union (numpy + scipy), the port's
counterpart of custom_d_fine_tpu/ops/hungarian.py (host_solve :17,
host_go_union :32).

The JAX package solves on the device with its own LAPJV (ops/lapjv.py) only
because its TPU runtime has no host callbacks; the port solves on the host,
as the reference does (src/d_fine/matcher.py:239-247; GO union
dfine_criterion.py:570-591). Valid GT columns are a prefix of each image's
padded columns, and only they reach the host (train/matcher.py): the packed
costs [S, Q * sum(n)] hold, in each set's row, every image's [Q, n_b] block
of its valid columns, row-major with the queries as rows, the images in
order, so image b's block starts at column Q * (n_0 + ... + n_{b-1}).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def host_solve(packed: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """packed [S, Q * sum(n)] costs (above), valid [B, G] bool (a prefix of
    each row) -> assign [S, B, G] int64 (query per GT, -1 for invalid GT
    slots). NaN costs count as 1.0. Exact (Jonker-Volgenant); ties may pick
    another equally optimal matching than another solver."""
    n_valid = valid.sum(1)
    out = np.full((packed.shape[0],) + valid.shape, -1, np.int64)
    total = int(n_valid.sum())
    if total == 0:
        return out
    Q = packed.shape[1] // total
    packed = np.nan_to_num(packed, nan=1.0)
    start = 0
    for b, n in enumerate(n_valid.tolist()):
        if n == 0:
            continue
        for s in range(packed.shape[0]):
            rows, cols = linear_sum_assignment(packed[s, start:start + Q * n].reshape(Q, n))
            out[s, b, cols] = rows
        start += Q * n
    return out


def host_go_union(assign: np.ndarray, n_valid: np.ndarray, num_queries: int):
    """GO union: per query keep the GT it was matched to most often across the
    output sets, ties to the smallest GT index. One np.unique over the
    matched (image, query, GT) keys and one sort by (image and query,
    -count, GT). Returns (best_g [B, Q], valid_q [B, Q])."""
    S, B, G = assign.shape
    best_g = np.zeros((B, num_queries), np.int64)
    valid_q = np.zeros((B, num_queries), bool)
    s, b, g = np.nonzero((assign >= 0) & (np.arange(G) < np.asarray(n_valid)[:, None]))
    keys, counts = np.unique((b * num_queries + assign[s, b, g]) * G + g, return_counts=True)
    bq, g = np.divmod(keys, G)
    order = np.lexsort((g, -counts, bq))
    bq, g = bq[order], g[order]
    first = np.ones(bq.shape, bool)
    first[1:] = bq[1:] != bq[:-1]
    best_g.flat[bq[first]] = g[first]
    valid_q.flat[bq[first]] = True
    return best_g, valid_q
