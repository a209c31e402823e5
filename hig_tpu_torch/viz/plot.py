"""Matplotlib 3D stick-figure animations of one- and two-person motions
(counterpart of ``hig_tpu/viz/plot.py``): the single-person root-centered
view with its ground trajectory, and the two-person shared-world view with
a color per actor, written as GIFs.

matplotlib is imported when a figure is drawn, not with this module: a
machine without it imports the module and fails only when asked to draw,
with :class:`ImportError` naming what is missing.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, the animation writer and the
    3-D axes."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

    return plt, FuncAnimation, PillowWriter


def _plot_floor(ax, minx, maxx, miny, minz, maxz):
    verts = [[minx, miny, minz], [minx, miny, maxz], [maxx, miny, maxz], [maxx, miny, minz]]
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    ax.add_collection3d(Poly3DCollection([verts], facecolors=(0.5, 0.5, 0.5, 0.3)))


def plot_3d_motion(
    save_path: str,
    kinematic_tree,
    joints: np.ndarray,
    title: str = "",
    figsize=(10, 10),
    fps: int = 20,
    radius: float = 4.0,
):
    """Single-person animation, root-centered with its ground trajectory."""
    plt, FuncAnimation, PillowWriter = _pyplot()
    joints = np.asarray(joints).reshape(len(joints), -1, 3).copy()
    frame_number = joints.shape[0]
    height_offset = joints[..., 1].min()
    joints[..., 1] -= height_offset
    trajec = joints[:, 0, [0, 2]].copy()
    joints[..., 0] -= joints[:, 0:1, 0]
    joints[..., 2] -= joints[:, 0:1, 2]

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    colors = ["red", "blue", "black", "red", "blue"]

    def update(index):
        ax.clear()
        ax.set_xlim(-radius / 2, radius / 2)
        ax.set_ylim(0, radius)
        ax.set_zlim(0, radius)
        ax.set_title(title)
        ax.grid(False)
        _plot_floor(
            ax,
            -radius / 2 - trajec[index, 0],
            radius / 2 - trajec[index, 0],
            0,
            -radius / 3 - trajec[index, 1],
            radius * 2 / 3 - trajec[index, 1],
        )
        if index > 1:
            ax.plot3D(
                trajec[:index, 0] - trajec[index, 0],
                np.zeros_like(trajec[:index, 0]),
                trajec[:index, 1] - trajec[index, 1],
                linewidth=1.0,
                color="blue",
            )
        for i, (chain, color) in enumerate(zip(kinematic_tree, colors)):
            lw = 4.0 if i < 5 else 2.0
            ax.plot3D(
                joints[index, chain, 0],
                joints[index, chain, 1],
                joints[index, chain, 2],
                linewidth=lw,
                color=color,
            )
        ax.view_init(elev=120, azim=-90)
        ax.dist = 7.5

    ani = FuncAnimation(fig, update, frames=frame_number, interval=1000 / fps, repeat=False)
    ani.save(save_path, writer=PillowWriter(fps=fps))
    plt.close(fig)


def plot_3d_motion2(
    save_path: str,
    kinematic_tree,
    joints1: np.ndarray,
    joints2: np.ndarray,
    title: str = "",
    figsize=(10, 10),
    fps: int = 20,
    radius: float = 4.0,
):
    """Two-person animation in the shared world frame, a color per actor."""
    plt, FuncAnimation, PillowWriter = _pyplot()
    j1 = np.asarray(joints1).reshape(len(joints1), -1, 3)
    j2 = np.asarray(joints2).reshape(len(joints2), -1, 3)
    frame_number = min(j1.shape[0], j2.shape[0])
    both = np.concatenate([j1, j2], axis=1)
    center = both[..., [0, 2]].reshape(-1, 2).mean(0)
    floor = both[..., 1].min()

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")

    def update(index):
        ax.clear()
        ax.set_xlim(center[0] - radius / 2, center[0] + radius / 2)
        ax.set_ylim(floor, floor + radius)
        ax.set_zlim(center[1] - radius / 2, center[1] + radius / 2)
        ax.set_title(title, fontsize=10)
        ax.grid(False)
        for joints, color in ((j1, "red"), (j2, "blue")):
            for chain in kinematic_tree:
                ax.plot3D(
                    joints[index, chain, 0],
                    joints[index, chain, 1],
                    joints[index, chain, 2],
                    linewidth=3.0,
                    color=color,
                )
        ax.view_init(elev=120, azim=-90)

    ani = FuncAnimation(fig, update, frames=frame_number, interval=1000 / fps, repeat=False)
    ani.save(save_path, writer=PillowWriter(fps=fps))
    plt.close(fig)


def plot_point_clouds(path: str, mesh1: np.ndarray, mesh2: np.ndarray, fps: int = 20,
                      max_points: int = 400) -> None:
    """A GIF of two fitted meshes (T, V, 3) as point clouds, one color per
    actor (``tools/render_smpl.py``'s stand-in for a mesh renderer)."""
    plt, FuncAnimation, PillowWriter = _pyplot()
    stride = max(1, mesh1.shape[1] // max_points)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    both = np.concatenate([mesh1, mesh2], axis=1)
    lo, hi = both.min(), both.max()

    def update(i):
        ax.clear()
        ax.set_xlim(lo, hi)
        ax.set_ylim(lo, hi)
        ax.set_zlim(lo, hi)
        ax.scatter(*mesh1[i, ::stride].T, s=1, c="red")
        ax.scatter(*mesh2[i, ::stride].T, s=1, c="blue")
        ax.view_init(elev=110, azim=-90)

    ani = FuncAnimation(fig, update, frames=mesh1.shape[0], interval=1000 / fps)
    ani.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
