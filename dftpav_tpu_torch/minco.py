"""MINCO minimum-jerk trajectory constants.

The MINCO system is assembled in normalized time (poly_traj_utils.hpp:
897-948), so its 6N x 6N matrix depends only on the piece count N: its
inverse is computed once on the host, and `generate` reduces to constant
matrix products. Normalized coefficients b[k] multiply tau^k, tau in [0, 1].
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def minco_matrix(N: int) -> np.ndarray:
    """The constant normalized-time MINCO constraint matrix A (6N x 6N)."""
    A = np.zeros((6 * N, 6 * N), dtype=np.float64)
    A[0, 0] = 1.0
    A[1, 1] = 1.0
    A[2, 2] = 2.0
    for i in range(N - 1):
        r, c = 6 * i, 6 * i
        A[r + 3, c + 3] = 6.0
        A[r + 3, c + 4] = 24.0
        A[r + 3, c + 5] = 60.0
        A[r + 3, c + 9] = -6.0
        A[r + 4, c + 4] = 24.0
        A[r + 4, c + 5] = 120.0
        A[r + 4, c + 10] = -24.0
        A[r + 5, c:c + 6] = 1.0
        A[r + 6, c:c + 6] = 1.0
        A[r + 6, c + 6] = -1.0
        A[r + 7, c + 1:c + 6] = (1.0, 2.0, 3.0, 4.0, 5.0)
        A[r + 7, c + 7] = -1.0
        A[r + 8, c + 2:c + 6] = (2.0, 6.0, 12.0, 20.0)
        A[r + 8, c + 8] = -2.0
    A[6 * N - 3, 6 * N - 6:] = 1.0
    A[6 * N - 2, 6 * N - 5:] = (1.0, 2.0, 3.0, 4.0, 5.0)
    A[6 * N - 1, 6 * N - 4:] = (2.0, 6.0, 12.0, 20.0)
    return A


@functools.lru_cache(maxsize=None)
def minco_inverse(N: int) -> np.ndarray:
    """Host-precomputed A^-1 (float64)."""
    return np.linalg.inv(minco_matrix(N))


@functools.lru_cache(maxsize=None)
def minco_maps(N: int):
    """Columns of A^-1 matching the sparse MINCO right-hand side:
    b = Mh @ head_scaled + Mi @ inner + Mt @ tail_scaled.
    Returns (Mh [6N,3], Mi [6N,N-1], Mt [6N,3]) float64."""
    Ainv = minco_inverse(N)
    Mh = Ainv[:, 0:3].copy()
    Mi = Ainv[:, 5:6 * (N - 1):6].copy()
    Mt = Ainv[:, 6 * N - 3:].copy()
    return Mh, Mi, Mt


def maps_as(N: int, dtype=torch.float32, device=None):
    """minco_maps(N) as tensors of `dtype` on `device`."""
    return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                 for m in minco_maps(N))


@functools.lru_cache(maxsize=None)
def subdivision_matrix(r: int) -> np.ndarray:
    """A [r, 6, 6]: A[i] maps a piece's normalized coefficients to those of
    its i-th of r equal sub-pieces. p(tau) = sum_k b_k tau^k with
    tau = (i + u) / r gives b'_m = sum_{k>=m} C(k, m) i^(k-m) r^-k b_k on
    the local u in [0, 1] (an exact identity)."""
    from math import comb
    A = np.zeros((r, 6, 6))
    for i in range(r):
        for m in range(6):
            for k in range(m, 6):
                A[i, m, k] = comb(k, m) * float(i) ** (k - m) / float(r) ** k
    return A


def subdivide(b: torch.Tensor, r: int) -> torch.Tensor:
    """Normalized coefficients [n, 6, 2, ...] of pieces of duration dT ->
    [n r, 6, 2, ...] on sub-pieces of duration dT / r."""
    if r == 1:
        return b
    A = torch.as_tensor(subdivision_matrix(r), dtype=b.dtype, device=b.device)
    out = torch.einsum("imk,qk...->qim...", A, b)
    return out.reshape(b.shape[0] * r, *b.shape[1:])
