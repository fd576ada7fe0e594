"""Runtime utilities of the port: checkpoint/resume, metrics logging,
profiling and streamed history IO.  ``utils/xla.py`` of the JAX package
(XLA flags, the persistent compile cache) has no counterpart."""

from .checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
from .metrics import MetricsLogger  # noqa: F401
from .profiling import trace  # noqa: F401
