"""Frozen, hashable configuration of the PyTorch port.

A field-for-field copy of :mod:`msgwam_tpu.config` (same names, same
defaults), so that one configuration drives both packages.  It is copied
rather than imported because importing ``msgwam_tpu.config`` runs
``msgwam_tpu/__init__.py``, which imports jax, and the port must import
without jax.

The backend strings keep their names; their meaning in the port:

* ``projection_backend``: ``"xla"`` is an ``index_add_`` scatter,
  ``"mxu"`` a dense torch matmul, ``"pallas"`` the hand-written CUDA
  deposit kernel (:mod:`msgwam_tpu_torch.ops.projection_cuda`).
* ``interp_backend``: ``"gather"`` is ``np.interp``-exact indexing,
  ``"mxu"`` a dense hat-basis matmul.
* ``rhs_backend``: ``"xla"`` is the composable torch RHS, ``"pallas"``
  the hand-written fused CUDA RHS kernels: K2 at full width
  (``window_cells=0``, :mod:`msgwam_tpu_torch.ops.rhs_cuda`), else K3 with
  a per-tile height window and, in ``rk3_step``, K4 with the RK3 stage
  fused in (:mod:`msgwam_tpu_torch.ops.rhs_cuda_windowed`).

The comments on the fields below are those of the JAX package, except
for the window fields, which describe the port's kernels; speeds quoted
in the others were measured on a TPU and say nothing about the port.
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np


def deg2rad(x: float) -> float:
    return float(np.deg2rad(x))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Physics + numerics configuration (hashable, immutable).

    Field-by-field mapping onto the reference defaults installed at
    ``lib/libprop.py:703-726`` (reference name in parentheses when renamed):
    """

    # --- wave / background physics (model_config keys) -------------------
    u0: float = 80.0                      # jet amplitude [m/s]
    phi0: float = deg2rad(-60)            # latitude [rad]
    sig_phi: float = deg2rad(3)           # jet width in phi [rad]
    rr0: float = 30000.0                  # jet center height [m]
    rr1: float = 40000.0                  # (set-but-unread in reference)
    sig_rr: float = 10000.0               # jet vertical scale [m]
    drr: float = 1.0                      # (set-but-unread in reference)
    bvf: float = 0.01                     # Brunt-Väisälä frequency N [1/s]
    geostrophy: bool = True               # (set-but-unread in reference)
    boussinesq: bool = False              # constant-density switch
    hh: float = 8500.0                    # density scale height [m]
    rhobar0: float = 1.2                  # surface density [kg/m^3]
    kappa: float = 0.95                   # saturation safety factor
    saturate_online: bool = True          # saturate inside the RHS vs offline

    # --- propagation switches --------------------------------------------
    hprop: bool = True                    # HPROP_GLOBAL (lib/libprop.py:5)

    # --- build-side numerics (no reference counterpart) ------------------
    # Reproduce reference quirk 1 (lib/libprop.py:601-613): the saturation
    # cap is an *integrated* action but is assigned to the *density* without
    # dividing by the phase-space volume.  True = bit-faithful; False =
    # consistent units (cap / phase_volume).
    faithful_saturation: bool = True
    # Reproduce reference quirk 2 (raytracer.py:184): the offline-saturation
    # height rate is divided by 1 instead of dt.  True = bit-faithful.
    faithful_offline_rates: bool = True
    # Reproduce reference quirk 3 (raytracer.py:221): the last wave-action
    # diagnostic frame reads rr_up from timestep nproj[0]=0 instead of
    # nproj[1]-1 (an index typo).  Only affects
    # diagnostics.reference_window_diagnostics.  True = frame-for-frame
    # faithful; False = corrected indexing.
    faithful_diag_index: bool = True
    # Max number of grid cells a single ray volume may overlap in the
    # projection scatter (static for XLA).  The reference's Python loop has
    # no such bound; any ray with (nup - nlow) > max_span would be silently
    # truncated, so pick max_span >= ceil(max dr / dz) + 1.
    max_span: int = 4
    # Computation dtype for state and physics ("float32" or "float64").
    dtype: str = "float64"
    # Projection backend: "xla" (segment_sum scatter; parity mode) or
    # "mxu" (dense weight-matrix matmul; TPU fast path).
    projection_backend: str = "xla"
    # Pseudo-momentum-flux deposit accumulation: "native" sums at the
    # working dtype; "compensated" (mxu backend) computes 8192-ray block
    # partials on the MXU and Kahan-combines them at working precision —
    # deposit error ~1e-7 at 1e6 f32 rays with no x64 dependency; "f64"
    # combines block partials in float64.
    flux_accum: str = "native"
    # Interpolation backend: "gather" (np.interp-exact; parity mode) or
    # "mxu" (hat-basis matmul; TPU fast path).
    interp_backend: str = "gather"
    # Time integrator: "rk3" (the reference's Williamson low-storage RK3,
    # lib/libprop.py:680-700), "rk4", or "euler".
    integrator: str = "rk3"
    # RHS backend: "xla" (composable jnp ops, any configuration) or
    # "pallas" (one fused TPU kernel per RHS evaluation; float32,
    # hprop=False only — see ops/rhs_pallas.py).
    rhs_backend: str = "xla"
    # Height window of the windowed fused kernels K3-K5 (pallas backend
    # only).  Each 256-ray tile reads its interpolation tables only inside
    # a window of this many cells, placed in the kernel from the cells the
    # tile's active rays touch.  The width has a floor of 16 and rounds up
    # to a multiple of 8; 0 selects the full-width kernel K2 instead.  A
    # tile whose rays outgrow the window tries ``window_cells2`` and then
    # reads the whole table: the exact full-width path, inside the same
    # kernel, so a result never depends on the window.  The default -1
    # resolves to the 16-cell floor (``ops/rhs_cuda.py:resolve_champion``).
    window_cells: int = -1

    # Second window tier of the windowed kernels: a tile that outgrows
    # ``window_cells`` tries this wider window before the full width.
    # Rounded up to a multiple of 8 and capped at c_pad - 8; 0 disables
    # it, and so does any width not above ``window_cells``.  The default
    # -1 resolves to off.  Results are exact on every path.
    window_cells2: int = -1

    # Prognostic mean flow (wave–mean-flow coupling on).  False freezes the
    # wind tendencies — a truly *fixed* background (BASELINE config 1), or,
    # combined with a prescribed wind function in ``simulate``, a transient
    # imposed background (BASELINE config 4's tidal shear).
    prognostic_mean: bool = True

    # --- culling / relaunch (build-side; BASELINE config 4) --------------
    cull: bool = False                    # enable critical-level/domain culling
    m_max: float = 2 * math.pi / 100.0    # |m| beyond this = critical level
    relaunch: bool = False                # refill culled slots from the source

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Uniform vertical grid (``raytracer.py:36-37,74-77``).

    ``n_face`` faces span [0, z_max]; cell centers ("staggered grid",
    ``grids`` in the reference) sit between faces.
    """

    n_face: int = 101
    z_max: float = 100e3

    @property
    def n_cell(self) -> int:
        return self.n_face - 1

    @property
    def dz(self) -> float:
        return self.z_max / (self.n_face - 1)

    def faces(self, dtype=np.float64) -> np.ndarray:
        return np.linspace(0.0, self.z_max, self.n_face, dtype=dtype)

    def centers(self, dtype=np.float64) -> np.ndarray:
        f = self.faces(dtype)
        return 0.5 * (f[:-1] + f[1:])


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Time-loop configuration (``raytracer.py:45-50``)."""

    dt: float = 120.0
    n_steps: int = 1440                   # 2 days at dt=120 s
    save_every: int = 1                   # history decimation factor


# The reference driver's overrides (``raytracer.py:53-64``): sine-jet wind,
# u0=4, kappa=1, phi0=0, offline saturation, no horizontal propagation.
REFERENCE_RUN_CONFIG = ModelConfig(
    bvf=0.01,
    boussinesq=False,
    sig_rr=10000.0,
    u0=4.0,
    rr0=40000.0,
    rr1=40000.0,
    phi0=0.0,
    kappa=1.0,
    saturate_online=False,
    hprop=False,
)
