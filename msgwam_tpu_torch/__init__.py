"""msgwam-tpu on PyTorch and CUDA: the port of :mod:`msgwam_tpu` to one
NVIDIA H100.

Same module layout and names as the JAX package.  State is a tree of
``NamedTuple``s of tensors on an explicit device; the time loop is plain
Python; the kernels that were Pallas on the TPU are hand-written CUDA for
Hopper (``csrc/``), built at first use.  This package imports ``torch``
and never ``jax``.

It covers the coupled vertical-propagation step (``hprop=False`` is the
fast path; ``hprop=True`` runs on the composable path) through
:func:`simulate`, with the lifecycle (cull, relaunch, keyed sources drawn
from a ``torch.Generator``), prescribed winds and the height sort; the
fused RHS kernels K2 (``rhs_backend="pallas", window_cells=0``), K3 and
the stage-fused K4 (``rhs_backend="pallas"`` with the default
``window_cells=-1`` or any other nonzero width), the deposit kernel K1
(``projection_backend="pallas"``); whole runs of the persistent kernel K5
through :func:`simulate_resident`, which routes the lifecycle, a
``wind_fn`` and the launch sort to K6 (``ops/step_cuda_stream.py``); and
ensembles in one launch of K7 (:func:`simulate_streaming_ensemble`,
``parallel.ensemble_simulate(backend="mega")``).  :mod:`.parallel` splits
the rays (or the ensemble's members) over the ranks of a
``torch.distributed`` mesh, one process per rank, with one all-reduce of
the flux per RHS evaluation (``parallel.sharded_simulate``; the kernel
routes K1, K2 and K4 shard too).

Gradients follow ``requires_grad`` on the inputs wherever the JAX package
has them: through :func:`simulate` (with ``remat`` True or ``"full"``:
``torch.utils.checkpoint``), the dense ``mxu`` interpolation and deposit
(residual-free backwards with the JAX package's tie conventions), and the
kernel routes K2-K5 and K7, whose backwards differentiate the plain path
(``ops/adjoint.py``).  K1 and K6 are forward only, as in the JAX package.

Around the core, as in the JAX package: the experiment driver
(``python -m msgwam_tpu_torch run``, :mod:`.cli`), the reference
``libprop`` shim (:mod:`.api`), the conservation diagnostics
(:mod:`.diagnostics`), checkpoints, metrics, profiling and streamed
history files (:mod:`.utils`), and plots (:mod:`.plotting`).
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
    cull,
    gaussian_spectrum_source,
    relaunch,
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
    project_reference_variant,
    saturate_direct,
    saturation_tendency,
    uniform_interp,
    wavenumber_tendencies,
)
from .ops.interp import interp  # noqa: F401
from .ops.step_cuda import simulate_resident  # noqa: F401
from .ops.step_cuda_stream import simulate_streaming_ensemble  # noqa: F401
from .parallel import (  # noqa: F401
    build_ensemble_fn,
    build_sharded_simulate_fn,
    ensemble_simulate,
    full_history_observe,
    full_history_observe_spec,
    gather_state,
    global_mesh,
    initialize_distributed,
    make_mesh,
    ray_sharding_specs,
    shard_state,
    sharded_simulate,
    sharded_step_fn,
    stack_ensemble,
)

__version__ = "0.1.0"
