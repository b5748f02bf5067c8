"""Fused static-corridor penalty, forward and closed-form backward: the
counterpart of `dftpav_tpu.ops.pallas_penalty` (whose Pallas kernels
`_fwd_kernel` and `_bwd_kernel` it replaces).

The corridor block of the objective (the static-obstacle term of
cost.segment_penalties, reference addPVAGradCost2CT traj_optimizer.cpp:
592-622) evaluates, for every constraint point and every ego-hull vertex,
the smoothed-L1 hinge of the signed distance to each corridor half-plane.
`CorridorPenalty` computes it per lane in one pass, and its backward
recomputes the hinge terms instead of keeping [*, E, H, B] intermediates.
For CUDA tensors forward and backward are the hand-written kernels K2
`dftpav_corridor_fwd` and K3 `dftpav_corridor_bwd` (csrc/penalty.cu,
per-row arithmetic in csrc/penalty.cuh); for CPU tensors they are the plain
versions below. A CUDA tensor reaches the kernel or the call raises.

Layout: the flattened constraint-point axis R = S*N*K1 and the lanes B are
the two minor axes of every operand: sig, dsig [2, R, B]; wq [1, R, B]
(quadrature weight with validity, segment mask and wei_obs folded in);
corr_n, corr_p [H, 2, R, B]; corr_mask [H, R, B] float; le the hull as E
(x, y) pairs. The gear sign is folded into dsig by the adapter
(R(singul * dsig) = singul * R(dsig)).

The backward (with w_eh = wq * S'(viol_eh) * mask_h, u = dx/|dsig|,
v = dy/|dsig|, R = [[u, -v], [v, u]], per lane cotangent gbar):

  d_sig    = gbar * sum_eh w_eh * n_h
  dL/du    = dR00 + dR11,  dL/dv = dR10 - dR01
             where dR_ij = sum_eh w_eh * n_i * le_{e,j}
  d_dsig_x = gbar * (dL/du (1 - u^2) - dL/dv u v) / |dsig|
  d_dsig_y = gbar * (-dL/du u v + dL/dv (1 - v^2)) / |dsig|
  d_wq     = gbar * sum_eh S(viol_eh) * mask_h

|dsig|^2 is clamped at 1e-8 and no row is skipped: rows that carry no
weight (wq = 0) give cost, d_sig and d_dsig 0, but d_wq is the hinge sum
there too. The loops run over the H half-planes of the tensors (the JAX
kernels loop over len(le) and are right only for H == E == 4).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from dftpav_tpu_torch.cost import _PE, smoothed_l1


def _smoothed_l1_grad(x):
    """Derivative of cost.smoothed_l1, in the clip form (finite everywhere)."""
    f3c = 1.0 / (_PE * _PE)
    f4c = -0.5 * f3c / _PE
    xc = torch.clamp(x, 0.0, _PE)
    small = (4.0 * f4c * xc + 3.0 * f3c) * xc * xc
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.where(x < _PE, small, torch.ones_like(x)))


def _uv(dsig):
    dx, dy = dsig[0], dsig[1]
    inv_vn = torch.rsqrt(torch.clamp(dx * dx + dy * dy, min=1e-8))
    return dx * inv_vn, dy * inv_vn, inv_vn


def _viols(sig, u, v, corr_n, corr_p, le):
    """Yields (e, h, viol [R, B]) over hull vertices e and half-planes h."""
    for e, (lex, ley) in enumerate(le):
        bx = sig[0] + u * lex - v * ley
        by = sig[1] + v * lex + u * ley
        for h in range(corr_n.shape[0]):
            yield e, h, (corr_n[h, 0] * (bx - corr_p[h, 0])
                         + corr_n[h, 1] * (by - corr_p[h, 1]))


def corridor_penalty_plain_fwd(sig, dsig, wq, corr_n, corr_p, corr_mask, le):
    """Per-lane corridor cost [B] (plain tensor ops, any device)."""
    u, v, _ = _uv(dsig)
    acc = torch.zeros_like(sig[0])
    for _e, h, viol in _viols(sig, u, v, corr_n, corr_p, le):
        acc = acc + smoothed_l1(viol) * corr_mask[h]
    return torch.sum(wq[0] * acc, dim=0)


def corridor_penalty_plain_bwd(sig, dsig, wq, corr_n, corr_p, corr_mask, le,
                               gbar):
    """(d_sig [2, R, B], d_dsig [2, R, B], d_wq [1, R, B]) for the per-lane
    cotangent gbar [B]: the closed form of the module docstring."""
    u, v, inv_vn = _uv(dsig)
    z = torch.zeros_like(sig[0])
    gx, gy, dR00, dR01, dR10, dR11, dwq = (z,) * 7
    for e, h, viol in _viols(sig, u, v, corr_n, corr_p, le):
        lex, ley = le[e]
        nx, ny, m = corr_n[h, 0], corr_n[h, 1], corr_mask[h]
        w = wq[0] * _smoothed_l1_grad(viol) * m
        gx = gx + w * nx
        gy = gy + w * ny
        dR00 = dR00 + w * nx * lex
        dR01 = dR01 + w * nx * ley
        dR10 = dR10 + w * ny * lex
        dR11 = dR11 + w * ny * ley
        dwq = dwq + smoothed_l1(viol) * m
    dLdu = dR00 + dR11
    dLdv = dR10 - dR01
    g = gbar[None, None, :]
    d_sig = torch.stack([gx, gy])
    d_dsig = torch.stack([(dLdu * (1.0 - u * u) - dLdv * u * v) * inv_vn,
                          (-dLdu * u * v + dLdv * (1.0 - v * v)) * inv_vn])
    return d_sig * g, d_dsig * g, dwq[None] * g


def corridor_fwd(sig, dsig, wq, corr_n, corr_p, corr_mask, le):
    """Forward [B]: kernel K2 for CUDA tensors, the plain version for CPU
    tensors."""
    if not sig.is_cuda:
        return corridor_penalty_plain_fwd(sig, dsig, wq, corr_n, corr_p,
                                          corr_mask, le)
    from dftpav_tpu_torch.ops import _cuda

    corridor_fwd.launches += 1
    return _cuda.launch_corridor_fwd(sig, dsig, wq, corr_n, corr_p,
                                     corr_mask, le)


def corridor_bwd(sig, dsig, wq, corr_n, corr_p, corr_mask, le, gbar):
    """Backward (d_sig, d_dsig, d_wq): kernel K3 for CUDA tensors, the
    plain closed form for CPU tensors."""
    if not sig.is_cuda:
        return corridor_penalty_plain_bwd(sig, dsig, wq, corr_n, corr_p,
                                          corr_mask, le, gbar)
    from dftpav_tpu_torch.ops import _cuda

    corridor_bwd.launches += 1
    return _cuda.launch_corridor_bwd(sig, dsig, wq, corr_n, corr_p,
                                     corr_mask, le, gbar.contiguous())


corridor_fwd.launches = 0
corridor_bwd.launches = 0


class CorridorPenalty(torch.autograd.Function):
    """Per-lane corridor cost [B] from kernel-layout inputs, differentiable
    in sig, dsig and wq; corridor_n/p/mask and le are constants."""

    @staticmethod
    def forward(ctx, sig, dsig, wq, corr_n, corr_p, corr_mask, le):
        ctx.le = le
        ctx.save_for_backward(sig, dsig, wq, corr_n, corr_p, corr_mask)
        return corridor_fwd(sig, dsig, wq, corr_n, corr_p, corr_mask, le)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        d_sig, d_dsig, d_wq = corridor_bwd(*ctx.saved_tensors, ctx.le, gbar)
        return d_sig, d_dsig, d_wq, None, None, None, None


def kernel_layout(sig, dsig, singul, wq, corr_n, corr_p, corr_mask, wei_obs):
    """bcost shapes -> the contiguous kernel layout (sig, dsig, wq, corr_n,
    corr_p, corr_mask) of the module docstring.

    sig/dsig [S, N, K1, 2, B]; singul [S, B] in sig's dtype; wq
    [S, N, K1, B]; corr_n/p [S, N, K1, H, 2, B]; corr_mask [S, N, K1, H, B]
    bool; wei_obs a scalar."""
    S, N, K1, _, B = sig.shape
    R = S * N * K1
    sgn = singul[:, None, None, None, :]
    H = corr_n.shape[3]
    return (sig.reshape(R, 2, B).movedim(1, 0).contiguous(),
            (dsig * sgn).reshape(R, 2, B).movedim(1, 0).contiguous(),
            (wq * wei_obs).reshape(1, R, B).contiguous(),
            corr_n.reshape(R, H, 2, B).movedim(0, 2).contiguous(),
            corr_p.reshape(R, H, 2, B).movedim(0, 2).contiguous(),
            corr_mask.to(sig.dtype).reshape(R, H, B).movedim(0, 1)
            .contiguous())


def hull_tuple(le):
    """The hull [E, 2] as a tuple of (x, y) Python floats."""
    return tuple((float(x), float(y)) for x, y in np.asarray(le))


def corridor_cost_pallas(sig, dsig, singul, wq, corr_n, corr_p, corr_mask,
                         le, wei_obs):
    """The weighted corridor cost [B] from bcost shapes through
    CorridorPenalty (the adapter of dftpav_tpu.ops.pallas_penalty); le is
    the hull [E, 2] (numpy)."""
    return CorridorPenalty.apply(
        *kernel_layout(sig, dsig, singul, wq, corr_n, corr_p, corr_mask,
                       wei_obs), hull_tuple(le))
