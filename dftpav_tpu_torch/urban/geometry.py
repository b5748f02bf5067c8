"""Oriented-bounding-box geometry for vehicle collision checks (the port of
`dftpav_tpu/urban/geometry.py`): a separating-axis test on 2D rectangles
that broadcasts over any batch shape."""

from __future__ import annotations

import torch


def obb_vertices(x, y, theta, length, width, d_cr):
    """Footprint corners [..., 4, 2] of a vehicle at rear-axle pose
    (x, y, theta); the body rectangle is centered d_cr ahead of the axle."""
    c, s = torch.cos(theta), torch.sin(theta)
    cx = x + d_cr * c
    cy = y + d_cr * s
    hl = torch.as_tensor(length, dtype=x.dtype, device=x.device) / 2.0
    hw = torch.as_tensor(width, dtype=x.dtype, device=x.device) / 2.0
    lx = torch.stack([hl, hl, -hl, -hl], dim=-1)
    ly = torch.stack([hw, -hw, -hw, hw], dim=-1)
    vx = cx[..., None] + lx * c[..., None] - ly * s[..., None]
    vy = cy[..., None] + lx * s[..., None] + ly * c[..., None]
    return torch.stack([vx, vy], dim=-1)


def _project_gap(verts_a, verts_b, axes):
    """Max signed gap of B beyond A over the given axes [..., K, 2]."""
    pa = (verts_a[..., None, :, :] * axes[..., :, None, :]).sum(-1)
    pb = (verts_b[..., None, :, :] * axes[..., :, None, :]).sum(-1)
    gap1 = pb.amin(-1) - pa.amax(-1)
    gap2 = pa.amin(-1) - pb.amax(-1)
    return torch.maximum(gap1, gap2).amax(-1)


def obb_overlap(verts_a, verts_b):
    """True where rectangles [..., 4, 2] overlap (separating-axis theorem)."""
    def axes_of(v):
        e = torch.stack([v[..., 1, :] - v[..., 0, :],
                         v[..., 3, :] - v[..., 0, :]], dim=-2)
        n = torch.sqrt((e * e).sum(-1, keepdim=True))
        return e / torch.clamp(n, min=1e-9)

    va, vb = torch.broadcast_tensors(verts_a, verts_b)
    axes = torch.cat([axes_of(va), axes_of(vb)], dim=-2)
    return _project_gap(va, vb, axes) < 0.0


def vehicles_collide(state_a, state_b, param_a, param_b, inflate=0.0):
    """OBB overlap between agent states [..., 6] (steer.STATE_DIM layout);
    param_* = (length, width, d_cr), each a float or a tensor that
    broadcasts with the states' batch. ``inflate`` grows each footprint by
    the margin on every side."""
    la, wa, da = param_a
    lb, wb, db = param_b
    va = obb_vertices(state_a[..., 0], state_a[..., 1], state_a[..., 2],
                      la + 2 * inflate, wa + 2 * inflate, da)
    vb = obb_vertices(state_b[..., 0], state_b[..., 1], state_b[..., 2],
                      lb + 2 * inflate, wb + 2 * inflate, db)
    return obb_overlap(va, vb)
