"""Ensembles of independent members: the counterpart of the ensemble half
of :mod:`msgwam_tpu.parallel`.  Ray sharding over devices and
``distributed.initialize`` are ROADMAP queue 1, item 8."""

from .ensemble import (  # noqa: F401
    ENSEMBLE_AXIS,
    build_ensemble_fn,
    ensemble_simulate,
    stack_ensemble,
)
