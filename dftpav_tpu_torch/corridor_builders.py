"""Alternative safe-corridor builders: star-convex "galaxy" and ellipsoid
decomposition.

The parking pipeline's default rectangle corridor lives in the native front
end (native/dftpav_native.cpp, reference getRectangleConst
traj_manager.cpp:1213-1469). The reference additionally ships two point-cloud
based builders that these functions reproduce:

  * corridorBuilder2d — flip-based star-convex region ("galaxy"), reference
    include/plan_utils/CorridorBuilder2d.hpp:12-132 (OpenCV hulls there);
  * EllipsoidDecomp2D (Sikang Liu's decomp_util) used by getSikangConst,
    reference traj_manager.cpp:803-900 +
    utils/DecompROS/decomp_ros_utils/include/decomp_util/.

Both are host-side NumPy (corridor construction is part of the sequential
front end); outputs use the planner's (outward normal, point) half-plane
convention so they slot directly into Scenario.corr_n/corr_p.
"""

from __future__ import annotations

import numpy as np

from dftpav_tpu_torch import geo


def _hpoly_from_vertices(verts: np.ndarray) -> np.ndarray:
    """CCW vertices [V, 2] -> hPoly [V, 4] rows (nx, ny, px, py), outward
    normals (the reference's 4xV hPoly transposed, CorridorBuilder2d.hpp:120-127)."""
    V = len(verts)
    out = np.zeros((V, 4))
    for i in range(V):
        a, b = verts[i], verts[(i + 1) % V]
        ray = b - a
        n = np.array([ray[1], -ray[0]])
        n = n / max(np.linalg.norm(n), 1e-12)
        # CCW polygon -> (ray.y, -ray.x) points outward
        out[i] = [n[0], n[1], a[0], a[1]]
    return out


def star_convex_corridor(origin, points, radius: float = 100.0,
                         max_x: float = 50.0, max_y: float = 50.0,
                         add_points=None) -> np.ndarray:
    """Flip-based star-convex corridor around ``origin`` (corridorBuilder2d).

    points: obstacle points [N, 2]. Returns hPoly [V, 4] rows
    (outward normal, boundary point). Algorithm (CorridorBuilder2d.hpp):
      1. flip every obstacle point p -> p + 2 (R - |p|) p/|p| about origin;
      2. convex hull of flipped points: hull members are the visible
         obstacle points -> star-convex polygon w.r.t. origin;
      3. pick an interior point (origin, nudged inward if it lies on the hull);
      4. convexify: half-planes through consecutive star vertices, keep the
         intersection (the reference does this with a dual-point hull).
    """
    origin = np.asarray(origin, dtype=np.float64)
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    if add_points is not None:
        pts = np.vstack([pts, np.asarray(add_points, float).reshape(-1, 2)])
    rel = pts - origin
    keep = (np.abs(rel[:, 0]) <= max_x) & (np.abs(rel[:, 1]) <= max_y)
    rel = rel[keep]
    norms = np.linalg.norm(rel, axis=1)
    safe_radius = min(radius, norms.min()) if len(norms) else radius
    nz = norms > 1e-9
    rel, norms = rel[nz], norms[nz]
    if len(rel) < 3:
        # free space: fall back to the local box
        box = np.array([[max_x, max_y], [-max_x, max_y],
                        [-max_x, -max_y], [max_x, -max_y]]) + origin
        return _hpoly_from_vertices(geo.convex_hull2d(box))

    flipped = rel + 2.0 * (radius - norms)[:, None] * rel / norms[:, None]
    flip_all = np.vstack([flipped, [[0.0, 0.0]]])  # origin participates
    hull = geo.convex_hull2d(flip_all)
    # map hull members back to the original points
    star = []
    origin_on_hull = False
    for h in hull:
        idx = np.where(np.all(np.isclose(flip_all[:-1], h, atol=1e-9),
                              axis=1))[0]
        if len(idx):
            star.append(rel[idx[0]])
        else:
            origin_on_hull = True
    star = np.asarray(star)
    if len(star) < 3:
        box = np.array([[max_x, max_y], [-max_x, max_y],
                        [-max_x, -max_y], [max_x, -max_y]]) + origin
        return _hpoly_from_vertices(geo.convex_hull2d(box))

    if origin_on_hull:
        centroid = star.mean(axis=0)
        d = np.linalg.norm(centroid)
        interior = 0.99 * safe_radius * centroid / max(d, 1e-9)
    else:
        interior = np.zeros(2)

    # star polygon in CCW order around the interior point
    ang = np.arctan2(star[:, 1] - interior[1], star[:, 0] - interior[0])
    star = star[np.argsort(ang)]

    # half-planes through consecutive star vertices (outward of interior)
    A_rows, b_rows = [], []
    V = len(star)
    for j in range(V):
        a, b_ = star[j], star[(j + 1) % V]
        ray = b_ - a
        n = np.array([ray[1], -ray[0]])
        nn = np.linalg.norm(n)
        if nn < 1e-12:
            continue
        n = n / nn
        if n @ (a - interior) < 0:
            n = -n
        A_rows.append(n)
        b_rows.append(n @ a)
    verts = geo.halfplane_vertices(np.asarray(A_rows), np.asarray(b_rows))
    if len(verts) < 3:
        verts = star
    return _hpoly_from_vertices(verts + origin)


def ellipsoid_decomp2d(p1, p2, points, offset: float = 0.1,
                       max_planes: int = 12) -> tuple[np.ndarray, np.ndarray]:
    """Sikang Liu's 2D ellipsoid decomposition around segment p1-p2.

    Reference: decomp_util's LineSegment::dilate (ellipsoid grown from the
    segment, shrunk to the closest obstacle, tangent half-planes peeled off
    until no points remain inside), used by getSikangConst
    (traj_manager.cpp:803-900). Returns (hPoly [V, 4], ellipse (C [2,2],
    center [2]) with E = {C u + center : |u| <= 1}).
    """
    p1 = np.asarray(p1, float)
    p2 = np.asarray(p2, float)
    pts = np.asarray(points, float).reshape(-1, 2)
    center = 0.5 * (p1 + p2)
    axis = p2 - p1
    a = 0.5 * np.linalg.norm(axis) + offset
    theta = np.arctan2(axis[1], axis[0]) if np.linalg.norm(axis) > 1e-9 else 0.0
    R = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])

    # shrink the minor axis until no obstacle point is inside the ellipse
    b = a
    rel = (pts - center) @ R  # points in ellipse-aligned coords
    for _ in range(100):
        inside = (rel[:, 0] / a) ** 2 + (rel[:, 1] / b) ** 2 < 1.0 - 1e-9
        if not inside.any():
            break
        cand = rel[inside]
        # choose b so the closest inside point lies ON the ellipse
        frac = 1.0 - (cand[:, 0] / a) ** 2
        frac = np.maximum(frac, 1e-9)
        b_needed = np.sqrt(cand[:, 1] ** 2 / frac)
        b = min(b, float(np.min(b_needed[np.isfinite(b_needed)])) - 1e-9)
        if b <= 1e-6:
            b = 1e-6
            break
    C = R @ np.diag([a, b]) @ R.T

    # peel tangent half-planes at the closest remaining points
    Cinv = np.linalg.inv(C)
    remaining = pts.copy()
    A_rows, b_rows = [], []
    for _ in range(max_planes):
        if len(remaining) == 0:
            break
        u = (remaining - center) @ Cinv.T      # ellipse coords
        d = np.linalg.norm(u, axis=1)
        i = int(np.argmin(d))
        p_star = remaining[i]
        # tangent plane of the dilated ellipse through p_star
        n = Cinv.T @ Cinv @ (p_star - center)
        n = n / max(np.linalg.norm(n), 1e-12)
        A_rows.append(n)
        b_rows.append(n @ p_star)
        keep = (remaining - center) @ n < n @ (p_star - center) - 1e-12
        remaining = remaining[keep]

    # bounding box keeps the polytope finite
    lim = max(a, 10.0) * 2.0
    for n in (np.array([1.0, 0]), np.array([-1.0, 0]),
              np.array([0, 1.0]), np.array([0, -1.0])):
        A_rows.append(n)
        b_rows.append(n @ center + lim)
    verts = geo.halfplane_vertices(np.asarray(A_rows), np.asarray(b_rows))
    return _hpoly_from_vertices(verts), (C, center)
