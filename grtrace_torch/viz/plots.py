"""Scene diagnostics: top-down, close-up 3D, embedding 3D, single-ray
4-panel — the port's copy of `grtrace.viz.plots` (numpy and matplotlib
only), the same artifacts in the same visual language.

matplotlib is imported when a figure is drawn, not with this module: the
port runs where matplotlib may be missing (the CLIs check `available()`
before they render, and skip the figures with --no-plots).
"""
from __future__ import annotations

import os

import numpy as np


def available() -> bool:
    """Whether matplotlib imports here."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _mpl():
    """(pyplot, cm, LineCollection, Line2D, Line3DCollection) on the Agg
    backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm
    from matplotlib.collections import LineCollection
    from matplotlib.lines import Line2D
    from mpl_toolkits.mplot3d.art3d import Line3DCollection
    return plt, cm, LineCollection, Line2D, Line3DCollection


def _ensure_dir(path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def _decimate(traj, max_points):
    n = traj.shape[0]
    if n > max_points:
        return traj[:: n // max_points]
    return traj


def _horizon_mesh(rs, n_u=40, n_v=20):
    u, v = np.mgrid[0:2 * np.pi:complex(0, n_u), 0:np.pi:complex(0, n_v)]
    return (rs * np.cos(u) * np.sin(v), rs * np.sin(u) * np.sin(v),
            rs * np.cos(v))


def plot_scene_topdown(bh, observer, image_plane_size, boundary_radius,
                       out_path="images/scene_topdown.png", fov_deg=50,
                       patch_center_theta=np.pi / 2,
                       patch_size_theta=np.deg2rad(10),
                       patch_size_phi=np.deg2rad(10),
                       photon_trajectories=None):
    """x-y scene view (parity: visualization/plot.py:16-100)."""
    plt, _, _, _, _ = _mpl()
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.add_patch(plt.Circle((0, 0), bh.rs, color="black", label="Black Hole"))
    obs_x, obs_y = observer.position[0], observer.position[1]
    ax.plot(obs_x, obs_y, "ro", label="Observer", markersize=10)
    ax.add_patch(plt.Circle((0, 0), boundary_radius, color="gray",
                            fill=False, linestyle="--", label="Boundary"))

    fov = observer.fov
    n_pix = image_plane_size[0]
    obs_angle = np.arctan2(-obs_y, -obs_x)
    for th in (obs_angle - fov / 2, obs_angle + fov / 2):
        ax.plot([obs_x, obs_x + 2 * boundary_radius * np.cos(th)],
                [obs_y, obs_y + 2 * boundary_radius * np.sin(th)],
                "k--", lw=1, alpha=0.7)

    # background patch arc opposite the observer
    patch_phi = (np.arctan2(obs_y, obs_x) + np.pi) % (2 * np.pi)
    phis = np.linspace(patch_phi - patch_size_phi / 2,
                       patch_phi + patch_size_phi / 2, 200)
    ax.plot(boundary_radius * np.cos(phis), boundary_radius * np.sin(phis),
            color="magenta", lw=6, alpha=0.5, label="Background Patch")

    # image-plane arc with per-pixel ticks
    plane_radius = 0.2 * np.hypot(obs_x, obs_y)
    plane_thetas = np.linspace(obs_angle - fov / 2, obs_angle + fov / 2, n_pix)
    px = obs_x + plane_radius * np.cos(plane_thetas)
    py = obs_y + plane_radius * np.sin(plane_thetas)
    ax.plot(px, py, color="blue", lw=3, alpha=0.5, label="Image Plane (arc)")
    for x, y in zip(px, py):
        ax.plot([obs_x, x], [obs_y, y], color="blue", lw=0.5, alpha=0.2)

    if photon_trajectories is not None:
        labeled = False
        for traj in photon_trajectories:
            traj = _decimate(np.asarray(traj), 100)
            ax.plot(traj[:, 0], traj[:, 1], color="orange", lw=0.5,
                    alpha=0.3, label=None if labeled else "Sampled Rays")
            labeled = True
            ax.scatter(traj[0, 0], traj[0, 1], color="lime", s=20, zorder=16)
            ax.scatter(traj[-1, 0], traj[-1, 1], color="red", s=20, zorder=16)

    ax.set_aspect("equal")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_title("Top-Down Scene View (Simulation Geometry)")
    handles, labels = ax.get_legend_handles_labels()
    ax.legend(dict(zip(labels, handles)).values(),
              dict(zip(labels, handles)).keys())
    lim = max(boundary_radius, np.hypot(obs_x, obs_y)) * 1.1
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    _ensure_dir(out_path)
    plt.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    print(f"Saved top-down scene image to {out_path}")


def _image_plane_corners(obs_pos, fov, image_plane_size):
    obs_r = np.linalg.norm(obs_pos)
    plane_dist = 0.2 * obs_r
    plane_center = obs_pos - (obs_pos / obs_r) * plane_dist
    up = np.array([0, 0, 1.0])
    if np.allclose(np.cross(obs_pos, up), 0):
        up = np.array([0, 1.0, 0])
    right = np.cross(up, obs_pos)
    right = right / np.linalg.norm(right)
    up_vec = np.cross(obs_pos, right)
    up_vec = up_vec / np.linalg.norm(up_vec)
    width = 2 * plane_dist * np.tan(fov / 2)
    height = width * (image_plane_size[0] / image_plane_size[1])
    pts = []
    for dx, dy in [(-.5, -.5), (.5, -.5), (.5, .5), (-.5, .5), (-.5, -.5)]:
        pts.append(plane_center + dx * width * right + dy * height * up_vec)
    return np.array(pts)


def plot_scene_embedding_3d(bh, observer, image_plane_size, boundary_radius,
                            out_path="images/scene_topdown_3d.png",
                            fov_deg=None, photon_trajectories=None,
                            patch_center_theta=None, patch_center_phi=None,
                            patch_size_theta=np.deg2rad(10),
                            patch_size_phi=np.deg2rad(10),
                            override_patch_center=False,
                            flat_trajectories=None,
                            azimuths=(0, 45, 90, 135, 180, 225, 270, 315)):
    """3D scene with horizon, boundary, patch, rays; saved at 8 azimuths
    (parity: visualization/plot.py:104-245)."""
    plt, _, _, Line2D, _ = _mpl()
    fov = observer.fov if fov_deg is None else np.deg2rad(fov_deg)
    obs_pos = np.asarray(observer.position, dtype=float)
    rs = bh.rs

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(*obs_pos, color="red", s=100, label="Observer")

    corners = _image_plane_corners(obs_pos, fov, image_plane_size)
    ax.plot(corners[:, 0], corners[:, 1], corners[:, 2], color="blue", lw=2,
            label="Image Plane")

    xb, yb, zb = _horizon_mesh(boundary_radius)
    ax.plot_wireframe(xb, yb, zb, color="gray", alpha=0.05, label="Boundary")

    if (not override_patch_center or patch_center_theta is None
            or patch_center_phi is None):
        opp = -obs_pos
        r_opp = np.linalg.norm(opp)
        patch_center_theta = np.arccos(opp[2] / r_opp)
        patch_center_phi = np.arctan2(opp[1], opp[0])
    th = np.linspace(patch_center_theta - patch_size_theta / 2,
                     patch_center_theta + patch_size_theta / 2, 100)
    ph = np.linspace(patch_center_phi - patch_size_phi / 2,
                     patch_center_phi + patch_size_phi / 2, 200)
    tg, pg = np.meshgrid(th, ph, indexing="ij")
    ax.plot_surface(boundary_radius * np.sin(tg) * np.cos(pg),
                    boundary_radius * np.sin(tg) * np.sin(pg),
                    boundary_radius * np.cos(tg),
                    color="magenta", alpha=0.2, linewidth=0,
                    antialiased=True, zorder=10)

    if photon_trajectories:
        for traj in photon_trajectories:
            traj = np.asarray(traj)
            ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], color="orange", lw=1,
                    alpha=1.0, zorder=15)
            ax.scatter(*traj[0], color="lime", s=20, zorder=16)
            ax.scatter(*traj[-1], color="red", s=20, zorder=16)
    else:
        print("[plot_scene_embedding_3d] Warning: no sampled rays to plot.")

    if flat_trajectories is not None:
        for traj in flat_trajectories:
            traj = np.asarray(traj)
            ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], color="blue", lw=1,
                    alpha=0.7)

    xs, ys, zs = _horizon_mesh(rs)
    ax.plot_surface(xs, ys, zs, color="black", alpha=1.0, zorder=20)
    ax.plot_wireframe(xs, ys, zs, color="yellow", linewidth=0.1, zorder=21)

    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.set_title("3D Scene: Schwarzschild Embedding & Simulation Geometry")
    max_range = max(boundary_radius, np.linalg.norm(obs_pos)) * 1.1
    for axis in "xyz":
        getattr(ax, f"set_{axis}lim")([-max_range, max_range])
    ax.legend(handles=[
        Line2D([0], [0], marker="o", color="w", label="Observer",
               markerfacecolor="red", markersize=10),
        Line2D([0], [0], color="black", lw=4, label="Event Horizon"),
        Line2D([0], [0], color="orange", lw=2, label="Sampled Rays"),
        Line2D([0], [0], color="blue", lw=2, label="Straight Rays"),
        Line2D([0], [0], color="magenta", lw=2, label="Background Patch"),
    ])
    _ensure_dir(out_path)
    plt.tight_layout()
    base, ext = os.path.splitext(out_path)
    for azim in azimuths:
        ax.view_init(elev=30, azim=azim)
        fig.savefig(f"{base}_azim{azim}{ext}")
        print(f"Saved 3D embedding scene image to {base}_azim{azim}{ext}")
    plt.close(fig)


def plot_scene_closeup_3d(bh, observer, image_plane_size,
                          out_path="images/scene_closeup_3d.png",
                          fov_deg=None, photon_trajectories=None):
    """Close-up near the observer (parity: visualization/plot.py:247-349)."""
    plt, _, _, Line2D, _ = _mpl()
    fov = observer.fov if fov_deg is None else np.deg2rad(fov_deg)
    obs_pos = np.asarray(observer.position, dtype=float)
    corners = _image_plane_corners(obs_pos, fov, image_plane_size)

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    xs, ys, zs = _horizon_mesh(bh.rs)
    ax.plot_surface(xs, ys, zs, color="black", alpha=1.0, zorder=20)
    ax.plot_wireframe(xs, ys, zs, color="yellow", linewidth=0.7, zorder=21)
    ax.scatter(*obs_pos, color="red", s=100, label="Observer")

    if photon_trajectories is not None:
        for traj in photon_trajectories:
            traj = _decimate(np.asarray(traj), 100)
            ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], color="orange", lw=1,
                    alpha=1.0, zorder=15)
            ax.scatter(*traj[0], color="lime", s=20, zorder=16)
            ax.scatter(*traj[-1], color="red", s=20, zorder=16)

    ax.plot(corners[:, 0], corners[:, 1], corners[:, 2], color="blue", lw=2,
            label="Image Plane")

    pts = np.vstack([corners, obs_pos[None, :], np.zeros((1, 3))])
    center = (pts.min(0) + pts.max(0)) / 2
    half = 0.5 * 1.15 * (pts.max(0) - pts.min(0)).max()
    for axis, c in zip("xyz", center):
        getattr(ax, f"set_{axis}lim")(c - half, c + half)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.set_title("Close-up 3D Scene: Observer, Image Plane, Event Horizon")
    ax.legend(handles=[
        Line2D([0], [0], marker="o", color="w", label="Observer",
               markerfacecolor="red", markersize=10),
        Line2D([0], [0], color="black", lw=4, label="Event Horizon"),
        Line2D([0], [0], color="blue", lw=2, label="Image Plane"),
    ])
    _ensure_dir(out_path)
    plt.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    print(f"Saved close-up 3D scene image to {out_path}")


# ---------------------------------------------------------------------------
# Single-ray diagnostics (parity: single_ray_cuda_test.py:40-239)
# ---------------------------------------------------------------------------

def alpha_from_b(b, r0, mass=1.0):
    """Impact parameter -> launch angle: sin(a) = b / (r0 sqrt(1 - 2M/r0))
    (single_ray_cuda_test.py:40-45)."""
    sin_alpha = b / r0 / np.sqrt(1 - 2 * mass / r0)
    if sin_alpha >= 1:
        raise ValueError("Chosen b is too large for this r0 (sin a > 1).")
    return np.arcsin(sin_alpha)


def make_colour_segments(xs, ys, zs=None, cmap=None):
    """Index-coloured Line(3D)Collection (single_ray_cuda_test.py:229-239);
    cmap defaults to viridis."""
    plt, cm, LineCollection, _, Line3DCollection = _mpl()
    cmap = cm.viridis if cmap is None else cmap
    pts = (np.column_stack((xs, ys)) if zs is None
           else np.column_stack((xs, ys, zs)))
    segments = np.stack([pts[:-1], pts[1:]], axis=1)
    norm = plt.Normalize(0, len(xs) - 1)
    colors = cmap(norm(np.arange(len(xs) - 1)))
    lc = (LineCollection(segments, colors=colors, linewidth=2) if zs is None
          else Line3DCollection(segments, colors=colors, linewidth=2))
    return lc, cmap, norm


def plot_geodesic(traj, *, mass_bh=1.0, cmap=None, step=1000,
                  out_path="single_ray_test.png"):
    """4-panel lambda-coloured figure: 3D, x-y, x-z, orbital-plane polar
    (parity: single_ray_cuda_test.py:47-157).  traj: (steps, 4) = (t,r,th,ph);
    cmap defaults to plasma.
    """
    plt, cm, _, _, _ = _mpl()
    cmap = cm.plasma if cmap is None else cmap
    traj = np.asarray(traj)
    rs = 2.0 * mass_bh
    t, r, th, ph = traj.T
    xs = (r * np.sin(th) * np.cos(ph))[::step]
    ys = (r * np.sin(th) * np.sin(ph))[::step]
    zs = (r * np.cos(th))[::step]

    obs_vec = np.array([xs[0], ys[0], zs[0]])
    v_vec = (np.array([xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0]])
             if len(xs) > 1 else obs_vec)
    n_hat = np.cross(obs_vec, v_vec)
    n_norm = np.linalg.norm(n_hat)
    n_hat = n_hat / n_norm if n_norm > 0 else np.array([0.0, 0.0, 1.0])
    e1 = obs_vec - np.dot(obs_vec, n_hat) * n_hat
    e1 = e1 / np.linalg.norm(e1)
    e2 = np.cross(n_hat, e1)
    u = xs * e1[0] + ys * e1[1] + zs * e1[2]
    v = xs * e2[0] + ys * e2[1] + zs * e2[2]

    norm = plt.Normalize(0, len(xs) - 1)
    fig = plt.figure(figsize=(10, 8))

    ax3d = fig.add_subplot(221, projection="3d")
    lc3d, _, _ = make_colour_segments(xs, ys, zs, cmap=cmap)
    ax3d.add_collection3d(lc3d)
    hx, hy, hz = _horizon_mesh(rs)
    ax3d.plot_wireframe(hx, hy, hz, color="gray", alpha=0.25, linewidth=0.4)
    ax3d.scatter(0, 0, 0, c="k", s=40, label="BH")
    ax3d.scatter(*obs_vec, c="r", s=25, label="observer")
    ax3d.plot([0, obs_vec[0]], [0, obs_vec[1]], [0, obs_vec[2]],
              color="gray", linestyle="--", linewidth=0.8, alpha=0.4)
    ax3d.set_xlabel("x"); ax3d.set_ylabel("y"); ax3d.set_zlabel("z")
    ax3d.set_title("3-D trajectory")
    ax3d.legend()

    circ = np.linspace(0, 2 * np.pi, 400)
    for idx, (a, b, lbl) in enumerate(((xs, ys, ("x", "y")),
                                       (xs, zs, ("x", "z")))):
        axp = fig.add_subplot(222 + idx)
        lc, _, _ = make_colour_segments(a, b, cmap=cmap)
        axp.add_collection(lc)
        axp.plot(rs * np.cos(circ), rs * np.sin(circ), color="gray",
                 alpha=0.25)
        axp.plot([0, obs_vec[0]], [0, obs_vec["xyz".index(lbl[1])]],
                 color="gray", linestyle="--", linewidth=0.8, alpha=0.4)
        axp.set_xlabel(lbl[0]); axp.set_ylabel(lbl[1])
        axp.set_title("-".join(lbl))
        axp.axis("equal"); axp.autoscale()

    ax_pol = fig.add_subplot(224, projection="polar")
    ax_pol.scatter(np.arctan2(v, u), np.hypot(u, v),
                   c=np.arange(len(u)), cmap=cmap, s=4, norm=norm)
    ax_pol.plot(np.linspace(0, 2 * np.pi, 400), np.full(400, rs),
                color="gray", alpha=0.25)
    ax_pol.set_title("orbital plane (r, theta')")
    ax_pol.set_rlabel_position(45)

    cax = fig.add_axes([0.92, 0.15, 0.02, 0.68])
    plt.colorbar(cm.ScalarMappable(norm=norm, cmap=cmap), cax=cax,
                 label="index 0 -> final (time)")
    fig.tight_layout(rect=[0, 0, 0.9, 1])
    _ensure_dir(out_path)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    print(f"Saved single-ray figure to {out_path}")
