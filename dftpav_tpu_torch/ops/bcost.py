"""Batch-minor helpers that turn optimized decision variables into MINCO
coefficients (cost.unpack / boundary_states / minco.generate with the batch
as the trailing axis), used once per solve by pallas_solve._finalize."""

from __future__ import annotations

import torch

from dftpav_tpu_torch.cost import Unpacked
from dftpav_tpu_torch.types import Dims, Scenario, Weights


def to_bminor(tree):
    """Move the leading batch axis of every leaf to the back."""
    return type(tree)(*(torch.movedim(a, 0, -1) for a in tree))


def unpack_b(x: torch.Tensor, dims: Dims) -> Unpacked:
    """Decision matrix [dim, B] -> parts with trailing B."""
    S, N = dims.S, dims.N
    B = x.shape[-1]
    n_in = S * (N - 1) * 2
    inner = x[:n_in].reshape(S, N - 1, 2, B)
    vt = x[n_in:n_in + S]
    gp = x[n_in + S:n_in + S + 2 * (S - 1)].reshape(max(S - 1, 0), 2, B)
    ga = x[n_in + S + 2 * (S - 1):]
    return Unpacked(inner, vt, gp, ga)


def boundary_states_b(scen: Scenario, u: Unpacked, w: Weights, dims: Dims):
    """Per-segment head/tail PVA [S, 2, 3, B]. Gear-junction overrides
    (costFunctionCallback:269-282) exist only for S > 1, which this slice
    does not cover."""
    if dims.S > 1:
        raise NotImplementedError(
            "multi-gear (S > 1) is not ported yet: ROADMAP.md Queue 1 item 6")
    return scen.ini_state, scen.fin_state


def generate_b(inner, dT, heads, tails, maps):
    """MINCO solve over [S, ..., B]: inner [S, N-1, 2, B], dT [S, B],
    heads/tails [S, 2, 3, B] -> normalized coeffs [S, N, 6, 2, B]."""
    Mh, Mi, Mt = maps
    N = Mh.shape[0] // 6
    S, B = dT.shape[0], dT.shape[-1]
    scale = torch.stack([torch.ones_like(dT), dT, dT * dT])   # [3, S, B]
    sc = scale.permute(1, 0, 2)[:, :, None]                   # [S, 3, 1, B]
    hs = heads.permute(0, 2, 1, 3) * sc                       # [S, 3, 2, B]
    ts = tails.permute(0, 2, 1, 3) * sc
    b = (torch.einsum("ik,skdb->sidb", Mh, hs)
         + torch.einsum("ik,skdb->sidb", Mi, inner)
         + torch.einsum("ik,skdb->sidb", Mt, ts))
    return b.reshape(S, N, 6, 2, B)
