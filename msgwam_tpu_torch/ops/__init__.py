"""Compute kernels of the port: dispersion, interpolation, the ray→grid
projection and saturation in plain torch, plus the hand-written CUDA
kernels K1 (``projection_cuda``), K2 (``rhs_cuda``), K3/K4
(``rhs_cuda_windowed``), K5 (``step_cuda``) and K6/K7
(``step_cuda_stream``), whose twins share ``ray_physics``."""

# ``interp`` (the function) stays out of this namespace, where the name is
# the submodule's
from .interp import basis_interp, basis_matrix, grid_interp, uniform_interp  # noqa: F401
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
    project_interfaces,
    project_reference_variant,
    projection_weights,
    required_span,
)
from .saturation import saturation_cap, saturate_direct, saturation_tendency  # noqa: F401
