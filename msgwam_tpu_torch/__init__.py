"""msgwam-tpu on PyTorch and CUDA: the port of :mod:`msgwam_tpu` to one
NVIDIA H100.

Same module layout and names as the JAX package.  State is a tree of
``NamedTuple``s of tensors on an explicit device; the time loop is plain
Python; the kernels that were Pallas on the TPU are hand-written CUDA for
Hopper (``csrc/``), built at first use.  This package imports ``torch``
and never ``jax``.

This slice covers the coupled vertical-propagation step (``hprop=False``
is the fast path; ``hprop=True`` runs on the composable path) through
:func:`simulate`, with the fused RHS kernel K2 (``rhs_backend="pallas",
window_cells=0``) and the deposit kernel K1 (``projection_backend=
"pallas"``).
"""

from .config import GridConfig, ModelConfig, RunConfig, REFERENCE_RUN_CONFIG  # noqa: F401
from .constants import RAD_EARTH, ROT_EARTH  # noqa: F401
from .state import (  # noqa: F401
    Background,
    MeanState,
    RayState,
    RayStatics,
    State,
    coriolis,
    from_numpy,
    make_background,
    pad_rays,
    to_numpy,
    tree_axpy,
)
from .models import (  # noqa: F401
    gaussian_spectrum_source,
    rhs,
    rk3_step,
    simulate,
    step,
    williamson_rk3,
    tidal_shear,
    velocities_gauss_homogeneous,
    velocities_sine_homogeneous,
    velocities_tanh,
    velocities_tanh_homogeneous,
    wave_packet_ic,
)
from .ops import (  # noqa: F401
    cg_r,
    group_velocities,
    grid_interp,
    omega,
    project,
    saturate_direct,
    saturation_tendency,
    wavenumber_tendencies,
)

__version__ = "0.1.0"
