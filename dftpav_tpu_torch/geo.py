"""Geometry & polynomial kernels: the reference's L0 header-only layer.

Reference equivalents (src/Plan/traj_planner/include/geo_utils2d/):
  * sdlp.hpp (Seidel's randomized low-dim LP)     -> `linprog2d`
  * geoutils2d.hpp enumerateVs/findInterior       -> `halfplane_vertices`,
                                                     `chebyshev_center2d`
  * quickhull.hpp (convex hull)                   -> `convex_hull2d`
  * root_finder.hpp (polynomial roots)            -> `poly_roots`,
                                                     `poly_minmax_on_interval`

These are host-side NumPy utilities: the reference uses them inside the
optimizer's variable-packing (extractVs over corridor intersections,
traj_optimizer.h:191-234) and for trajectory extremum checks — branchy,
tiny-n work that belongs on the host, feeding static-shape arrays to the
device. The port keeps its own copy of `dftpav_tpu/geo.py`: it imports
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Convex hull (quickhull.hpp equivalent; 2D monotone chain)
# ---------------------------------------------------------------------------

def convex_hull2d(points: np.ndarray) -> np.ndarray:
    """CCW convex hull vertices of points [N, 2] (Andrew's monotone chain)."""
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: list = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1])


# ---------------------------------------------------------------------------
# Low-dimensional LP (sdlp.hpp equivalent)
# ---------------------------------------------------------------------------

def linprog2d(c: np.ndarray, A: np.ndarray, b: np.ndarray,
              bound: float = 1e7) -> np.ndarray | None:
    """min c.x s.t. A x <= b in 2D (Seidel's incremental algorithm).

    Returns the optimizer or None when infeasible. Same role as
    sdlp::linprog (sdlp.hpp) for the d=2 case the planner uses.
    """
    rng = np.random.default_rng(0)
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    # box bounds keep the incremental solution finite
    A = np.vstack([A, np.eye(2), -np.eye(2)])
    b = np.concatenate([b, [bound, bound, bound, bound]])
    order = rng.permutation(len(A))

    # start at the box corner minimizing c
    x = -bound * np.sign(c)
    x[c == 0] = 0.0

    for i, idx in enumerate(order):
        if A[idx] @ x <= b[idx] + 1e-12:
            continue
        # re-solve on the boundary A[idx] x = b[idx] (1D LP over prior rows)
        a = A[idx]
        n2 = a @ a
        if n2 < 1e-18:
            if b[idx] < -1e-12:
                return None
            continue
        # parameterize the line: x = p + t * d
        p = a * (b[idx] / n2)
        d = np.array([-a[1], a[0]])
        lo, hi = -np.inf, np.inf
        ok = True
        for jdx in order[:i]:
            aj, bj = A[jdx], b[jdx]
            ad = aj @ d
            rhs = bj - aj @ p
            if abs(ad) < 1e-14:
                if rhs < -1e-9:
                    ok = False
                    break
                continue
            t = rhs / ad
            if ad > 0:
                hi = min(hi, t)
            else:
                lo = max(lo, t)
        if not ok or lo > hi + 1e-12:
            return None
        cd = c @ d
        t = lo if cd > 0 else hi if cd < 0 else np.clip(0.0, lo, hi)
        t = np.clip(t, lo, hi)
        x = p + t * d
    return x


def chebyshev_center2d(A: np.ndarray, b: np.ndarray):
    """Deepest interior point of {x: Ax <= b} (geoutils::findInterior,
    geoutils2d.hpp:19-76 solves the same LP via sdlp).

    Returns (center [2], radius); radius <= 0 means empty interior.
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    norms = np.linalg.norm(A, axis=1)
    # variables (x, y, r): min -r s.t. A x + ||a|| r <= b  -> lift to 2D by
    # bisection on r using linprog2d feasibility
    lo, hi = 0.0, float(np.max(np.abs(b)) + 1.0)
    best = None
    for _ in range(50):
        r = 0.5 * (lo + hi)
        x = linprog2d(np.zeros(2), A, b - norms * r)
        if x is not None:
            best = (x, r)
            lo = r
        else:
            hi = r
    if best is None:
        x = linprog2d(np.zeros(2), A, b)
        return (x, 0.0) if x is not None else (None, -1.0)
    return best


def halfplane_vertices(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """V-representation of {x: Ax <= b} (geoutils::enumerateVs,
    geoutils2d.hpp:78-121: interior point + dual + hull; here direct
    pairwise-intersection enumeration, equivalent for 2D).

    Returns CCW vertices [V, 2]; empty array when the polytope is empty.
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    m = len(A)
    pts = []
    for i in range(m):
        for j in range(i + 1, m):
            M = np.stack([A[i], A[j]])
            det = np.linalg.det(M)
            if abs(det) < 1e-12:
                continue
            v = np.linalg.solve(M, np.array([b[i], b[j]]))
            if np.all(A @ v <= b + 1e-9):
                pts.append(v)
    if not pts:
        return np.zeros((0, 2))
    return convex_hull2d(np.asarray(pts))


# ---------------------------------------------------------------------------
# Polynomial roots (root_finder.hpp equivalent)
# ---------------------------------------------------------------------------

def poly_roots(coeffs: np.ndarray, lo: float | None = None,
               hi: float | None = None) -> np.ndarray:
    """Real roots of a polynomial with ascending coefficients c0 + c1 t + ...

    Companion-matrix eigenvalues (RootFinder solves the same problem with
    isolation + refinement, root_finder.hpp); optionally filtered to
    [lo, hi].
    """
    c = np.trim_zeros(np.asarray(coeffs, dtype=np.float64), "b")
    if len(c) <= 1:
        return np.zeros((0,))
    roots = np.roots(c[::-1])
    real = roots[np.abs(roots.imag) < 1e-9].real
    if lo is not None:
        real = real[real >= lo - 1e-12]
    if hi is not None:
        real = real[real <= hi + 1e-12]
    return np.sort(real)


def poly_minmax_on_interval(coeffs: np.ndarray, lo: float, hi: float):
    """(min, max) of the polynomial on [lo, hi] via derivative roots —
    the primitive behind the reference's trajectory feasibility extremum
    checks (Piece::checkMaxVelRate-style sweeps, poly_traj_utils.hpp)."""
    c = np.asarray(coeffs, dtype=np.float64)
    k = np.arange(len(c))
    dc = (c * k)[1:]
    cand = np.concatenate([[lo, hi], poly_roots(dc, lo, hi)])
    vals = np.polyval(c[::-1], cand)
    return float(vals.min()), float(vals.max())
