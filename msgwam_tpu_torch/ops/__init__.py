"""Compute kernels of the port: dispersion, interpolation, the ray→grid
projection and saturation in plain torch, plus the hand-written CUDA
kernels K1 (``projection_cuda``) and K2 (``rhs_cuda``)."""

from .interp import basis_interp, basis_matrix, grid_interp  # noqa: F401
from .dispersion import (  # noqa: F401
    omega,
    group_velocities,
    cg_r,
    wavenumber_tendencies,
)
from .projection import (  # noqa: F401
    project,
    project_backend,
    project_dense,
    projection_weights,
    required_span,
)
from .saturation import saturation_cap, saturate_direct, saturation_tendency  # noqa: F401
