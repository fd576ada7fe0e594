"""Model layer of the port: background profiles, the coupled RHS, time
integration, and ray sources."""

from .backgrounds import (  # noqa: F401
    velocities_tanh,
    velocities_tanh_homogeneous,
    velocities_gauss_homogeneous,
    velocities_sine_homogeneous,
    tidal_shear,
)
from .rhs import rhs  # noqa: F401
from .integrate import rk3_step, step, simulate, williamson_rk3  # noqa: F401
from .sources import wave_packet_ic, gaussian_spectrum_source  # noqa: F401
