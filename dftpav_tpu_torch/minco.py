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


def generate(inner: torch.Tensor, dT: torch.Tensor, head: torch.Tensor,
             tail: torch.Tensor, maps) -> torch.Tensor:
    """Solve the MINCO system of one segment per leading index
    (MinJerkOpt::generate, poly_traj_utils.hpp:953-986, the final tInv
    scaling deferred to evaluation): inner [..., N-1, 2] waypoints, dT
    [...] piece durations, head / tail [..., 2, 3] PVA boundary states
    (columns p, v, a), maps from maps_as(N) -> normalized coefficients
    [..., N, 6, 2]."""
    Mh, Mi, Mt = maps
    N = Mh.shape[0] // 6
    scale = torch.stack([torch.ones_like(dT), dT, dT * dT], dim=-1)[..., None]
    b = (Mh @ (head.transpose(-1, -2) * scale) + Mi @ inner
         + Mt @ (tail.transpose(-1, -2) * scale))
    return b.reshape(*b.shape[:-2], N, 6, 2)


def real_coeffs(b: torch.Tensor, dT: torch.Tensor) -> torch.Tensor:
    """Normalized [..., N, 6, 2] -> real-time coefficients c[k] =
    b[k] / dT^k (dT [...])."""
    k = torch.arange(6, dtype=b.dtype, device=b.device)
    return b * (dT[..., None] ** -k)[..., None, :, None]


def jerk_cost(b: torch.Tensor, dT: torch.Tensor) -> torch.Tensor:
    """Integral of squared jerk over a segment [..., N, 6, 2] of piece
    duration dT [...] -> [...]: the closed form of
    MinJerkOpt::getTrajJerkCost (poly_traj_utils.hpp:998-1009) in the real
    coefficients c3..c5, summed over the pieces."""
    c = real_coeffs(b, dT)
    c3, c4, c5 = c[..., 3, :], c[..., 4, :], c[..., 5, :]
    t1 = dT[..., None]
    t2 = t1 * t1
    t3 = t2 * t1
    t4 = t2 * t2
    t5 = t4 * t1
    e = (36.0 * torch.sum(c3 * c3, -1) * t1
         + 144.0 * torch.sum(c4 * c3, -1) * t2
         + 192.0 * torch.sum(c4 * c4, -1) * t3
         + 240.0 * torch.sum(c5 * c3, -1) * t3
         + 720.0 * torch.sum(c5 * c4, -1) * t4
         + 720.0 * torch.sum(c5 * c5, -1) * t5)
    return torch.sum(e, -1)


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


# ---------------------------------------------------------------------------
# Trajectory evaluation (flatness maps). Reference: plan_utils::Piece
# (poly_traj_utils.hpp:77-340). Tensors of any dtype, on any device.
# ---------------------------------------------------------------------------

def _tau_powers(tau: torch.Tensor, order: int) -> torch.Tensor:
    """[..., 6] rows of d^order/dtau^order of (1, tau, ..., tau^5), the
    powers built by iterated multiplication."""
    k = np.arange(6)
    coef = np.ones(6)
    for r in range(order):
        coef = coef * (k - r)
    coef = coef * (k >= order)
    expo = np.maximum(k - order, 0)
    pows = [torch.ones_like(tau)]
    for _ in range(5):
        pows.append(pows[-1] * tau)
    pows = torch.stack(pows, dim=-1)                     # [..., 6] = tau^k
    return torch.as_tensor(coef, dtype=tau.dtype, device=tau.device) \
        * pows[..., torch.as_tensor(expo, device=tau.device)]


def eval_derivatives(b: torch.Tensor, dT, tau: torch.Tensor,
                     orders=(0, 1, 2)) -> list:
    """sigma^(r)(tau * dT) for each requested derivative order.

    b: [..., 6, 2] normalized coefficients of the piece each tau falls in
    (already indexed by the caller); tau [...] in [0, 1]; dT broadcasts
    against tau. Returns tensors [..., 2]."""
    scale = torch.as_tensor(dT, dtype=b.dtype, device=b.device).unsqueeze(-1)
    out = []
    for r in orders:
        basis = _tau_powers(tau, r).to(b.dtype)
        out.append(torch.einsum("...k,...kd->...d", basis, b) * scale ** (-r))
    return out


def flat_states(dsig: torch.Tensor, ddsig: torch.Tensor, singul, wheel_base,
                eps: float = 1e-6):
    """Flatness map: (sigma', sigma'') -> (theta, v, a_lon, kappa, steer)
    (Piece::getAngle/getVel/getAcc/getCurv/getSteer,
    poly_traj_utils.hpp:237-300); kappa and a_lon are 0 at near-zero
    speed, as in the reference."""
    sg = torch.as_tensor(singul, dtype=dsig.dtype, device=dsig.device)
    vn = torch.linalg.norm(dsig, dim=-1)
    theta = torch.atan2(sg * dsig[..., 1], sg * dsig[..., 0])
    v = sg * vn
    safe = vn >= eps
    vn_s = torch.where(safe, vn, torch.ones_like(vn))
    cross = dsig[..., 0] * ddsig[..., 1] - dsig[..., 1] * ddsig[..., 0]
    dot = dsig[..., 0] * ddsig[..., 0] + dsig[..., 1] * ddsig[..., 1]
    zero = torch.zeros_like(vn)
    kappa = torch.where(safe, sg * cross / vn_s**3, zero)
    a_lon = torch.where(safe, sg * dot / vn_s, zero)
    steer = torch.atan(wheel_base * kappa)
    return theta, v, a_lon, kappa, steer


def eval_segment_states(b: torch.Tensor, dT, singul, wheel_base,
                        t: torch.Tensor) -> dict:
    """Full states of one segment trajectory b [N, 6, 2] (per-piece
    duration dT) at times t [...] from the segment's start, clamped to it
    (Trajectory::GetState, poly_traj_utils.hpp:378-406)."""
    N = b.shape[0]
    dT = torch.as_tensor(dT, dtype=b.dtype, device=b.device)
    tc = torch.clamp(t, min=0.0)
    tc = torch.minimum(tc, dT * N)
    idx = torch.clamp((tc / dT).to(torch.int64), 0, N - 1)
    tau = tc / dT - idx.to(b.dtype)
    pos, dsig, ddsig = eval_derivatives(b[idx], dT, tau, orders=(0, 1, 2))
    theta, v, a, kappa, steer = flat_states(dsig, ddsig, singul, wheel_base)
    return dict(pos=pos, dsigma=dsig, ddsigma=ddsig, theta=theta, vel=v,
                acc=a, curv=kappa, steer=steer)
