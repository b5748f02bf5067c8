"""Core data structures: static problem dimensions and NamedTuples of tensors.

Same classes and field order as `dftpav_tpu.types`. A problem class is fixed
by `Dims`; ragged reality is expressed with masks. Batched problems carry a
leading [B] axis on every leaf.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Dims:
    """Static problem dimensions.

    S: gear segments; N: pieces per segment; Ns: optional per-segment piece
    counts (each divides N); K / Kdes: interior and
    first/last-piece constraint resolution; H: corridor half-planes;
    O: dynamic obstacles; Po: pieces per obstacle trajectory.
    """

    S: int = 1
    N: int = 8
    K: int = 16
    Kdes: int = 32
    H: int = 4
    O: int = 0
    Po: int = 8
    Ns: tuple | None = None

    def __post_init__(self):
        if self.Ns is not None:
            ns = tuple(int(n) for n in self.Ns)
            assert len(ns) == self.S, (ns, self.S)
            assert all(2 <= n <= self.N and self.N % n == 0 for n in ns), \
                f"each Ns entry must be in [2, N] and divide N: {ns}"
            object.__setattr__(self, "Ns", ns)

    @property
    def ns_tuple(self) -> tuple:
        return self.Ns if self.Ns is not None else (self.N,) * self.S

    @property
    def K1(self) -> int:
        """Padded samples per piece (Kdes+1 columns; interior pieces masked)."""
        return self.Kdes + 1

    @property
    def n_inner(self) -> int:
        return self.N - 1

    @property
    def dim(self) -> int:
        """Packed decision length: inner waypoints, per-segment virtual
        time, gear positions and angles (traj_optimizer.cpp:80-88)."""
        return 2 * self.S * (self.N - 1) + self.S + 3 * (self.S - 1)


class Scenario(NamedTuple):
    """One planning problem (every leaf may carry a leading batch axis)."""

    ini_state: torch.Tensor       # [S, 2, 3] columns p, v, a
    fin_state: torch.Tensor       # [S, 2, 3]
    init_inner: torch.Tensor      # [S, N-1, 2]
    init_T: torch.Tensor          # [S]
    singul: torch.Tensor          # [S] int32 +1 forward / -1 reverse
    seg_mask: torch.Tensor        # [S] bool
    corr_n: torch.Tensor          # [S, N, K1, H, 2] outward unit normals
    corr_p: torch.Tensor          # [S, N, K1, H, 2] points on the planes
    corr_mask: torch.Tensor       # [S, N, K1, H] bool
    obs_coef: torch.Tensor        # [O, Po, 6, 2] normalized-time coeffs
    obs_dt: torch.Tensor          # [O]
    obs_rel_t0: torch.Tensor      # [O]
    obs_mask: torch.Tensor        # [O] bool


class Weights(NamedTuple):
    """Dynamic cost parameters (scalars; defaults from OptConfig)."""

    wei_obs: torch.Tensor
    wei_surround: torch.Tensor
    wei_feas: torch.Tensor
    wei_time: torch.Tensor
    max_forward_vel: torch.Tensor
    max_forward_acc: torch.Tensor
    max_forward_cur: torch.Tensor
    max_backward_vel: torch.Tensor
    max_backward_acc: torch.Tensor
    max_backward_cur: torch.Tensor
    surround_clearance: torch.Tensor
    non_sinv: torch.Tensor
    mini_t: torch.Tensor
    epis: torch.Tensor
    lse_alpha: torch.Tensor


def weights_from_config(opt, dtype=torch.float32, device="cuda") -> Weights:
    """Weights from an OptConfig, on the card unless `device` says
    otherwise (without a card, the default raises)."""
    return Weights(*(torch.tensor(float(getattr(opt, f)), dtype=dtype,
                                  device=device)
                     for f in Weights._fields))


class SolveResult(NamedTuple):
    """Output of the batched trajectory optimizer (leading [B] axis)."""

    coeffs: torch.Tensor      # [B, S, N, 6, 2] normalized-time coefficients
    dT: torch.Tensor          # [B, S] per-piece duration
    cost: torch.Tensor        # [B] final unscaled cost
    n_iters: torch.Tensor     # [B] int32
    status: torch.Tensor      # [B] int32 (lbfgs.Status)
    success: torch.Tensor     # [B] bool


def from_numpy(tree, cls=None, device="cuda", dtype=torch.float32):
    """Carry arrays (e.g. the JAX package's Scenario / Weights after
    `np.asarray` on every leaf, or a packed decision matrix x [DP, B]) into
    the port: floating leaves become `dtype` on `device` (the card unless
    the caller names another device; without a card the default raises),
    bool and integer leaves keep their kind. With `cls`, `tree` is a
    sequence of leaves in that NamedTuple's field order."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return torch.from_numpy(a.copy()).to(device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.from_numpy(a.astype(np.int32)).to(device)
        return torch.from_numpy(np.array(a, np.float64)).to(
            device=device, dtype=dtype)

    if cls is None:
        return leaf(tree)
    return cls(*(leaf(a) for a in tree))


def state_to_flat(pos, yaw, vel, acc, steer, wheel_base, singul, non_sig=0.2,
                  dtype=np.float64):
    """Bicycle state -> flat-output PVA matrix [2, 3] (numpy;
    kino_astar.cpp:834-857 getFlatState)."""
    pos = np.asarray(pos, dtype)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s], [s, c]], dtype)
    v = singul * non_sig if abs(vel) <= non_sig else singul * vel
    dp = R @ np.array([v, 0.0], dtype)
    ddp = R @ np.array([acc, np.tan(steer) / wheel_base * v * v], dtype)
    return np.stack([pos, dp, ddp], axis=1)
