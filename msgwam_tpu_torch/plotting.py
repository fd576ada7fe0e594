"""The reference's two-panel accuracy figure (``raytracer.py:247-290``):
wave action (mJ·s/m³) and wave-action tendency (mJ/m³) vs (time, altitude).

The counterpart of :mod:`msgwam_tpu.plotting`.  The functions take host
NumPy arrays (``tensor.cpu().numpy()``) and import matplotlib inside the
call, so the port imports and runs where matplotlib is not installed
(``--no-plot``).
"""

from __future__ import annotations

import numpy as np


def plot_wave_action_panels(
    time_s,
    centers_m,
    wave_action,
    tendency,
    plot_max_s: float = 24 * 3600,
    plot_ymax_km: float = 100.0,
    diag_scale: float = 1.0,
    show: bool = True,
    save_path=None,
):
    """Two pcolormesh panels in the reference's layout and units.

    Args:
      time_s: (n_t,) times [s].
      centers_m: (n_cell,) altitudes [m].
      wave_action: (n_t, n_cell) projected wave action [J s / m^3].
      tendency: (n_t, n_cell) wave-action tendency [J / m^3 / s-step].
    """
    import matplotlib
    if save_path is not None and not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.style.use("ggplot")
    time_s = np.asarray(time_s)
    centers_km = np.asarray(centers_m) / 1000.0
    wa = np.asarray(wave_action) * 1000.0
    td = np.asarray(tendency) * 1000.0

    fig, ax = plt.subplots(1, 2, figsize=(8, 4), sharex="all", sharey="all")
    wa_image = ax[0].pcolormesh(
        time_s / 3600.0, centers_km, wa.T, vmin=0, vmax=wa.max()
    )
    diag_image = ax[1].pcolormesh(
        time_s / 3600.0, centers_km, td.T,
        vmin=-diag_scale, vmax=diag_scale, cmap="bwr",
    )
    ax[0].set_xlim(0, plot_max_s / 3600.0)
    ax[0].set_ylim(0, plot_ymax_km)
    ax[0].set_ylabel("altitude (km)")
    ax[0].set_xlabel("time (h)")
    ax[1].set_xlabel("time (h)")
    fig.colorbar(wa_image, ax=ax[0], label="wave action (mJ s / m³)", extend="both")
    fig.colorbar(diag_image, ax=ax[1], label="wave action tendency (mJ / m³)", extend="both")
    fig.tight_layout(rect=[0, 0, 1, 1])
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
    if show:
        plt.show()
    return fig, ax


def plot_wind_evolution(
    time_s,
    centers_m,
    u_history,
    vmax: float = 15.0,
    show: bool = True,
    save_path=None,
):
    """Mean-wind evolution U(z, t) pcolormesh — the panel the reference
    driver sketches but leaves commented out (``raytracer.py:255-256``)."""
    import matplotlib
    if save_path is not None and not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.style.use("ggplot")
    fig, ax = plt.subplots(figsize=(5, 4))
    img = ax.pcolormesh(
        np.asarray(time_s) / 3600.0,
        np.asarray(centers_m) / 1000.0,
        np.asarray(u_history).T,
        vmin=-vmax, vmax=vmax, cmap="bwr",
    )
    ax.set_xlabel("time (h)")
    ax.set_ylabel("altitude (km)")
    fig.colorbar(img, ax=ax, label="U (m/s)")
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
    if show:
        plt.show()
    return fig, ax
