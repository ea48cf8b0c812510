"""Figures and animations (matplotlib, host-side).

Counterpart of swraytracing_tpu/analysis/plots.py. matplotlib is imported
inside each function, never at import: the package imports, and runs on
the card, where matplotlib is not installed; only these functions (the
CLI's `analyze`, the drivers' `monitor_every`) need it.

Covers the reference's visual outputs:
  * e(omega) loglog spectra over time windows
    (analysis/load_data.m:46-52, generate_image.m:41-67);
  * PV snapshot + packet overlay animation frames
    (qg_flow_ray_trace/qgflow_animation.m — PNG frames and an optional
    GIF instead of an AVI);
  * theory-vs-experiment omega histogram
    (ideal_omega_distribution.m);
  * the red-blue diverging colormap (qg_flow_ray_trace/redblue.m) is
    matplotlib's RdBu_r.
"""

from __future__ import annotations

import numpy as np

from . import spectra

__all__ = ["plot_energy_spectra", "plot_omega_pdf_check", "render_pv_frame",
           "animate_pv", "plot_trajectories"]


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_energy_spectra(omega, times_idx, f: float, offset: int = 500,
                        bins: int = 300, path=None, title=None):
    """loglog e(omega/f) at several time windows, with an omega^-2 guide
    (load_data.m:46-52; the reference's headline figure)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4.5))
    windows = spectra.omega_windows(omega, times_idx, offset)
    wmax = max(w.max() for w in windows if len(w))
    for i, (idx, w) in enumerate(zip(times_idx, windows)):
        c, e = spectra.energy_vs_omega(w, bins, wmax)
        keep = e > 0
        ax.loglog(c[keep] / f, e[keep], lw=2, label=f"frame {idx}")
    wf = np.geomspace(1.05, wmax / f, 50)
    e0 = spectra.energy_vs_omega(windows[-1], bins, wmax)[1].max()
    ax.loglog(wf, e0 * wf**-2.0, "k--", lw=1, label=r"$\omega^{-2}$")
    ax.set_xlabel(r"$\omega/f$")
    ax.set_ylabel(r"$e(\omega)$")
    if title:
        ax.set_title(title)
    ax.legend(fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=130)
        plt.close(fig)
    return fig


def plot_omega_pdf_check(omega_exp, U, k0, f, Cg, path=None):
    """Theory-vs-experiment absolute-frequency pdf
    (ideal_omega_distribution.m:1-24)."""
    plt = _mpl()
    fig, axes = plt.subplots(2, 1, figsize=(6, 5), sharex=True)
    ideal = spectra.ideal_omega_samples(U, k0, f, Cg)
    axes[0].hist(ideal, bins=80, density=True)
    axes[0].set_ylabel("pdf")
    axes[0].set_title(r"Theoretical distribution of $\omega$")
    axes[1].hist(np.ravel(np.asarray(omega_exp)), bins=80, density=True)
    axes[1].set_ylabel("pdf")
    axes[1].set_xlabel(r"$\omega$")
    axes[1].set_title(r"Experimental distribution of $\omega$")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=130)
        plt.close(fig)
    return fig


def render_pv_frame(q, grid, packet_x=None, packet_k=None, path=None,
                    title=None, vlim=None):
    """One PV contour frame with optional packet scatter/quiver overlay
    (qgflow_animation.m:60-101)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5.5, 5))
    q = np.asarray(q)
    if vlim is None:
        vlim = np.max(np.abs(q))
    X, Y = grid.meshgrid()
    pc = ax.pcolormesh(X, Y, q, cmap="RdBu_r", vmin=-vlim, vmax=vlim,
                       shading="auto")
    fig.colorbar(pc, ax=ax, shrink=0.85)
    if packet_x is not None:
        px = np.mod(np.asarray(packet_x), grid.Lx)
        ax.scatter(px[:, 0], px[:, 1], s=14, c="k", zorder=3)
        if packet_k is not None:
            pk = np.asarray(packet_k)
            nrm = np.maximum(np.linalg.norm(pk, axis=-1, keepdims=True),
                             1e-12)
            ax.quiver(px[:, 0], px[:, 1], *(pk / nrm).T, scale=25,
                      width=3e-3, color="0.2", zorder=3)
    ax.set_xlim(0, grid.Lx)
    ax.set_ylim(0, grid.Ly)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_trajectories(x_frames, k_frames, f: float, Cg: float, path=None,
                      background=None, grid=None):
    """Packet trajectories in x-space + k-space ring evolution + omega(t)
    — the raytracing_figures.m panels."""
    plt = _mpl()
    x_frames = np.asarray(x_frames)
    k_frames = np.asarray(k_frames)
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    if background is not None and grid is not None:
        X, Y = grid.meshgrid()
        axes[0].pcolormesh(X, Y, np.asarray(background), cmap="RdBu_r",
                           alpha=0.6, shading="auto")
    n_show = min(x_frames.shape[1], 40)
    for pth in range(n_show):
        axes[0].plot(x_frames[:, pth, 0], x_frames[:, pth, 1], lw=0.7)
    axes[0].set_title("trajectories")
    axes[0].set_xlabel("x")
    axes[0].set_ylabel("y")
    for pth in range(n_show):
        axes[1].plot(k_frames[:, pth, 0], k_frames[:, pth, 1], lw=0.7)
    axes[1].scatter(k_frames[0, :, 0], k_frames[0, :, 1], s=8, c="k")
    axes[1].set_title("wavevector paths")
    axes[1].set_xlabel("k")
    axes[1].set_ylabel("l")
    axes[1].set_aspect("equal")
    om = np.sqrt(f**2 + Cg**2 * np.sum(k_frames**2, -1))
    axes[2].plot(om / f, lw=0.7)
    axes[2].set_title(r"$\omega/f$ per packet")
    axes[2].set_xlabel("frame")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=130)
        plt.close(fig)
    return fig


def animate_pv(q_frames, grid, out_dir, packet_x_frames=None,
               times=None, gif_path=None):
    """Render PV frames (+ packet overlay) to PNGs and optionally a GIF
    (qgflow_animation.m's AVI equivalent). Returns the PNG paths.

    When the packet save cadence is denser than the PV cadence (the
    production drivers save packets every packet_steps_per_save flow
    steps but PV every steps_per_save), one frame is rendered per
    PACKET save, with the PV linearly interpolated in time between the
    bracketing flow frames — qgflow_animation.m:88-101's
    `alpha*q(i) + (1-alpha)*q(i-1)` blend. The cadence ratio is inferred
    from the frame counts (m packet frames per PV interval)."""
    import os

    os.makedirs(str(out_dir), exist_ok=True)
    q_frames = np.asarray(q_frames)
    vlim = float(np.max(np.abs(q_frames)))
    nq = q_frames.shape[0]
    npk = None if packet_x_frames is None else len(packet_x_frames)

    if npk is not None and npk > nq > 1:
        # dense packet cadence: m packet frames per PV interval
        m = int(round(npk / (nq - 1)))
        paths = []
        for s in range(npk):
            i = min(s // m, nq - 2)
            alpha = (s - i * m + 1) / m
            alpha = min(alpha, 1.0)
            q = (1.0 - alpha) * q_frames[i] + alpha * q_frames[i + 1]
            px = np.asarray(packet_x_frames)[s]
            t = None if times is None else float(np.asarray(times)[s])
            p = os.path.join(str(out_dir), f"pv_{s:05d}.png")
            render_pv_frame(q, grid, packet_x=px, path=p, vlim=vlim,
                            title=None if t is None else f"t = {t:.2f}")
            paths.append(p)
        if gif_path:
            _save_gif(paths, gif_path)
        return paths

    paths = []
    for i, q in enumerate(q_frames):
        px = (None if packet_x_frames is None
              else np.asarray(packet_x_frames)[i])
        t = None if times is None else float(np.asarray(times)[i])
        p = os.path.join(str(out_dir), f"pv_{i:05d}.png")
        render_pv_frame(q, grid, packet_x=px, path=p, vlim=vlim,
                        title=None if t is None else f"t = {t:.2f}")
        paths.append(p)
    if gif_path:
        _save_gif(paths, gif_path)
    return paths


def _save_gif(paths, gif_path):
    """The PNG frames as one GIF (needs Pillow, which raises if absent)."""
    from PIL import Image
    imgs = [Image.open(p) for p in paths]
    imgs[0].save(gif_path, save_all=True, append_images=imgs[1:],
                 duration=120, loop=0)
