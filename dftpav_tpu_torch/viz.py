"""Matplotlib visualization — replaces the reference's RViz marker pipeline
(traj_visualizer.cpp, decomp_ros_utils displays) with figure/PNG output.

All functions draw onto a provided axes and are composable:
    ax = plot_grid(grid)
    plot_corridors(ax, scen)
    plot_trajectory(ax, coeffs, dT, singul, vehicle)
"""

from __future__ import annotations

import numpy as np


def _axes(ax=None):
    if ax is not None:
        return ax
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    _, ax = plt.subplots(figsize=(10, 7))
    ax.set_aspect("equal")
    return ax


def plot_grid(grid, ax=None):
    """Occupancy grid as an image underlay."""
    ax = _axes(ax)
    ny, nx = grid.occ.shape
    extent = (grid.origin[0], grid.origin[0] + nx * grid.resolution,
              grid.origin[1], grid.origin[1] + ny * grid.resolution)
    ax.imshow(grid.occ, origin="lower", extent=extent, cmap="Greys",
              vmin=0, vmax=2, interpolation="nearest")
    return ax


def vehicle_outline(x, y, yaw, vehicle):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s], [s, c]])
    center = np.array([x, y]) + vehicle.d_cr * R[:, 0]
    hl, hw = vehicle.length / 2, vehicle.width / 2
    corners = np.array([[hl, hw], [hl, -hw], [-hl, -hw], [-hl, hw], [hl, hw]])
    return center + corners @ R.T


def plot_vehicle(ax, x, y, yaw, vehicle, color="tab:blue", alpha=0.6):
    o = vehicle_outline(x, y, yaw, vehicle)
    ax.plot(o[:, 0], o[:, 1], color=color, alpha=alpha, lw=1.0)


def plot_kino_path(ax, samples, color="tab:orange"):
    """Rough front-end path (PlanMeta.sample_traj)."""
    ax.plot(samples[:, 0], samples[:, 1], ".", ms=1.5, color=color,
            label="kino path")


def plot_corridors(ax, corr_n, corr_p, corr_mask, stride=8,
                   color="tab:green", alpha=0.25):
    """Rectangle corridors (4 half-planes each) as polygons.

    corr_*: [N, K1, 4, 2] one segment's constraint-point corridors.
    """
    N, K1 = corr_n.shape[:2]
    for i in range(N):
        for k in range(0, K1, stride):
            if not corr_mask[i, k].all():
                continue
            n, p = corr_n[i, k], corr_p[i, k]
            # rectangle vertices = intersections of adjacent planes
            verts = []
            for a in range(4):
                b = (a + 1) % 4
                A = np.stack([n[a], n[b]])
                rhs = np.array([n[a] @ p[a], n[b] @ p[b]])
                try:
                    verts.append(np.linalg.solve(A, rhs))
                except np.linalg.LinAlgError:
                    break
            if len(verts) == 4:
                verts.append(verts[0])
                v = np.array(verts)
                ax.plot(v[:, 0], v[:, 1], color=color, alpha=alpha, lw=0.8)


def plot_trajectory(ax, coeffs, dT, singul, vehicle, n=80, color="tab:blue",
                    footprints=8):
    """Optimized polynomial trajectory with sparse vehicle footprints."""
    from dftpav_tpu_torch.container import _eval_states_np

    N = coeffs.shape[0]
    ts = np.linspace(0.0, N * float(dT), n)
    st = _eval_states_np(np.asarray(coeffs), float(dT), singul,
                         vehicle.wheel_base, ts)
    pos, theta = st["pos"], st["theta"]
    ax.plot(pos[:, 0], pos[:, 1], "-", color=color, lw=2.0)
    for i in np.linspace(0, n - 1, footprints).astype(int):
        plot_vehicle(ax, pos[i, 0], pos[i, 1], theta[i], vehicle,
                     color=color, alpha=0.35)
    return ax


def plot_ego_track(ax, ego_states, color="tab:red"):
    """Closed-loop plant track (SimLog.ego)."""
    e = np.asarray(ego_states)
    ax.plot(e[:, 0], e[:, 1], "-", color=color, lw=1.2, label="ego track")


def save(ax, path, title=None, legend=True):
    import matplotlib.pyplot as plt
    if title:
        ax.set_title(title)
    if legend:
        h, lbl = ax.get_legend_handles_labels()
        if lbl:
            ax.legend(loc="upper right", fontsize=8)
    ax.figure.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(ax.figure)
