"""Trajectory wire format, the PolyTraj.msg counterpart (the port of
`dftpav_tpu/utils/serialization.py`).

A piecewise-polynomial trajectory as a JSON-able dict in the framework's
normalized-coefficient convention (`minco.generate` output): the same dict
and format string as the JAX package's, so that files cross between the two.
Inputs may be tensors (on any device) or arrays.
"""

from __future__ import annotations

import json

import numpy as np
import torch

FORMAT = "dftpav_tpu/poly_traj@1"


def _np(x, dtype=None):
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def trajectory_to_dict(coeffs, dT, singul, start_time: float = 0.0) -> dict:
    """coeffs [S, N, 6, 2] normalized, dT [S], singul [S] -> wire dict."""
    coeffs = _np(coeffs, np.float64)
    S, N = coeffs.shape[0], coeffs.shape[1]
    return dict(
        format=FORMAT,
        order=5,
        n_segments=int(S),
        n_pieces=int(N),
        start_time=float(start_time),
        singuls=[int(s) for s in _np(singul).reshape(-1)],
        piece_duration=[float(d) for d in _np(dT).reshape(-1)],
        coef_x=coeffs[..., 0].reshape(-1).tolist(),
        coef_y=coeffs[..., 1].reshape(-1).tolist(),
    )


def trajectory_from_dict(d: dict):
    """Inverse of trajectory_to_dict -> (coeffs [S, N, 6, 2], dT [S],
    singul [S], start_time) as numpy arrays."""
    if not d.get("format", "").startswith("dftpav_tpu/poly_traj"):
        raise ValueError(f"not a trajectory dict: format {d.get('format')!r}")
    S, N = d["n_segments"], d["n_pieces"]
    cx = np.asarray(d["coef_x"], dtype=np.float64).reshape(S, N, 6)
    cy = np.asarray(d["coef_y"], dtype=np.float64).reshape(S, N, 6)
    coeffs = np.stack([cx, cy], axis=-1)
    dT = np.asarray(d["piece_duration"], dtype=np.float64)
    singul = np.asarray(d["singuls"], dtype=np.int32)
    return coeffs, dT, singul, float(d["start_time"])


def save_trajectory(path: str, coeffs, dT, singul, start_time: float = 0.0):
    with open(path, "w") as f:
        json.dump(trajectory_to_dict(coeffs, dT, singul, start_time), f)


def load_trajectory(path: str):
    with open(path) as f:
        return trajectory_from_dict(json.load(f))
