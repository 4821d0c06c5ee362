"""Trajectory visualization (the SESyncVisualizer analog, matplotlib-based;
a copy of dpgo_tpu/viz.py).

The reference ships an optional Pangolin/OpenGL iterate animation
(C++/SESync/include/SESync/SESyncVisualizer.h); here a headless matplotlib
renderer writes trajectory figures and convergence plots to files. Host
numpy only; matplotlib is imported when a figure is drawn.
"""

from __future__ import annotations

import numpy as np


def plot_trajectory(t: np.ndarray, path: str, edges=None,
                    title: str = "trajectory", color_by_node=None):
    """Render a 2-D/3-D pose trajectory to `path` (png/pdf).

    t: [P, d] translations; edges: optional (i, j) arrays to draw loop
    closures; color_by_node: optional [P] node assignment for coloring.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = t.shape[1]
    fig = plt.figure(figsize=(8, 8))
    if d == 3:
        ax = fig.add_subplot(111, projection="3d")
    else:
        ax = fig.add_subplot(111)
        ax.set_aspect("equal")

    if color_by_node is not None:
        cmap = plt.get_cmap("tab10")
        for a in np.unique(color_by_node):
            sel = color_by_node == a
            pts = t[sel]
            ax.plot(*pts.T, ".", markersize=2, color=cmap(int(a) % 10),
                    label=f"node {a}")
        ax.legend(loc="best", fontsize=8)
    else:
        ax.plot(*t.T, "-", linewidth=0.5)

    if edges is not None:
        i, j = edges
        for k in range(len(i)):
            seg = np.stack([t[i[k]], t[j[k]]])
            ax.plot(*seg.T, "-", color="0.8", linewidth=0.3, zorder=-1)

    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def animate_iterates(iterates, path: str, title: str = "iterates",
                     fps: int = 10, stride: int = 1, edges=None):
    """Render an iterate animation to `path` (.gif): the SESyncVisualizer
    iterate-playback role, headless via matplotlib FuncAnimation + Pillow.

    iterates: sequence of [P, d] translation arrays (e.g. the translations
    of `DPGOSolver.run(log_iterates=True)`'s iterates). stride subsamples
    frames; axes limits are fixed to the union bounding box so the
    animation doesn't rescale between frames.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    frames = [np.asarray(x) for x in iterates][::max(stride, 1)]
    if not frames:
        raise ValueError("animate_iterates: empty iterate sequence")
    d = frames[0].shape[1]
    allpts = np.concatenate(frames, axis=0)
    lo, hi = allpts.min(axis=0), allpts.max(axis=0)
    pad = 0.05 * np.maximum(hi - lo, 1e-6)
    lo, hi = lo - pad, hi + pad

    fig = plt.figure(figsize=(7, 7))
    if d == 3:
        ax = fig.add_subplot(111, projection="3d")
        ax.set_zlim(lo[2], hi[2])
    else:
        ax = fig.add_subplot(111)
        ax.set_aspect("equal")
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    (line,) = ax.plot(*frames[0].T, "-", linewidth=0.6)
    if edges is not None:
        i, j = edges
        for k in range(len(i)):
            seg = np.stack([frames[-1][i[k]], frames[-1][j[k]]])
            ax.plot(*seg.T, "-", color="0.85", linewidth=0.3, zorder=-1)

    def update(k):
        f = frames[k]
        line.set_data(f[:, 0], f[:, 1])
        if d == 3:
            line.set_3d_properties(f[:, 2])
        ax.set_title(f"{title} — frame {k + 1}/{len(frames)}")
        return (line,)

    anim = animation.FuncAnimation(fig, update, frames=len(frames),
                                   blit=False)
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)


def plot_convergence(history: np.ndarray, path: str, f_star: float = None,
                     title: str = "convergence"):
    """history rows: (iter, 2*fobj, 2*grad) (`DPGOSolver.run` output)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    it = history[:, 0]
    if f_star is not None:
        ax1.semilogy(it, np.maximum(history[:, 1] - f_star, 1e-16))
        ax1.set_ylabel("2 fobj - 2 f*")
    else:
        ax1.plot(it, history[:, 1])
        ax1.set_ylabel("2 fobj")
    ax1.set_xlabel("iteration")
    ax2.semilogy(it, history[:, 2])
    ax2.set_xlabel("iteration")
    ax2.set_ylabel("2 |grad|")
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
