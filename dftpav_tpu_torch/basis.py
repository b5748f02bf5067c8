"""Constraint-point sampling constants (numpy host constants).

Per reference semantics (traj_optimizer.cpp:486-523): piece 0 and piece N-1
use resolution Kdes, interior pieces K; sample j of piece i sits at
tau = j / K_i; trapezoid weight 0.5 at the ends; the first sample of a
segment and the last sample of its last piece carry no penalty.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class SampleGrid:
    """Precomputed numpy constants for one (N, K, Kdes) problem class."""

    beta: tuple        # (beta0..beta4), each [N, K1, 6] float64
    tau: np.ndarray    # [N, K1] sample positions in [0, 1]
    alpha: np.ndarray  # [N, K1] == tau
    omg: np.ndarray    # [N, K1] trapezoid weights (0 on padded columns)
    mask: np.ndarray   # [N, K1] bool sample validity
    inv_k: np.ndarray  # [N] 1 / K_i
    pen_mask: np.ndarray  # [N, K1] bool, segment endpoints excluded
    frac: np.ndarray   # [N, K1] i + tau: sample time = frac * dT


def _basis_rows(tau: np.ndarray, order: int) -> np.ndarray:
    k = np.arange(6)
    coef = np.ones(6)
    for r in range(order):
        coef = coef * (k - r)
    expo = np.maximum(k - order, 0)
    return coef * tau[..., None] ** expo * (k >= order)


@functools.lru_cache(maxsize=None)
def sample_grid(N: int, K: int, Kdes: int) -> SampleGrid:
    K1 = max(K, Kdes) + 1
    ks = np.array([Kdes if (i == 0 or i == N - 1) else K for i in range(N)])
    j = np.arange(K1)[None, :]
    mask = j <= ks[:, None]
    tau = np.where(mask, j / ks[:, None], 0.0)
    omg = np.where((j == 0) | (j == ks[:, None]), 0.5, 1.0) * mask
    pen_mask = mask.copy()
    pen_mask[0, 0] = False
    pen_mask[N - 1, ks[N - 1]] = False
    frac = tau + np.arange(N)[:, None]
    beta = tuple(_basis_rows(tau, r) for r in range(5))
    return SampleGrid(beta=beta, tau=tau, alpha=tau, omg=omg, mask=mask,
                      inv_k=1.0 / ks, pen_mask=pen_mask, frac=frac)
