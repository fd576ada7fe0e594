"""The least time the card could take for one call of the flux deposit K1
(``csrc/projection.cu``, ``project_kernel``), counted from the call's
inputs as :mod:`.roofline` counts the other kernels': each input read
once, each output written once.  Per call of ``nvar`` value rows: every
slot's activity byte; for each active ray its ``nvar`` values, both edges
of its extent and its phase-space volume, float32 (two value rows: 21 B a
ray, the count of ``PERF.md``'s kernel table); ``nvar`` float32 rows of
``n_cells`` out; and the deposit's operations for each covered cell of
an active ray, as ``PERF.md``'s table counts them."""

from __future__ import annotations

from .roofline import DEPOSIT_CELL_OPS, bound_s

F32 = 4


def k1_bytes(n_slots: int, n_active: float, n_cells: int, nvar: int = 1) -> float:
    """Bytes one K1 call needs at least."""
    return n_slots + F32 * (nvar + 3) * n_active + F32 * nvar * n_cells


def k1_call_s(n_slots: int, n_active: float, n_cells: int, cells: float,
              nvar: int = 1) -> float:
    """K1's bound for one call: ``cells`` is the mean covered cells of an
    active ray."""
    return bound_s(k1_bytes(n_slots, n_active, n_cells, nvar),
                   DEPOSIT_CELL_OPS * cells * n_active)
