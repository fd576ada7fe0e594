"""Ray sharding over the ranks of a mesh and ensemble fan-out: the
counterpart of :mod:`msgwam_tpu.parallel`, with one process per rank
(``torch.distributed``) where JAX has one controller over devices."""

from .sharding import (  # noqa: F401
    RAY_AXIS,
    build_sharded_simulate_fn,
    full_history_observe,
    full_history_observe_spec,
    gather_state,
    make_mesh,
    ray_sharding_specs,
    shard_state,
    sharded_simulate,
    sharded_step_fn,
)
from .ensemble import (  # noqa: F401
    ENSEMBLE_AXIS,
    build_ensemble_fn,
    ensemble_simulate,
    stack_ensemble,
)
from .distributed import (  # noqa: F401
    P,
    global_mesh,
    initialize as initialize_distributed,
    local_device,
    make_global_sharded,
)
