"""``ref_1e7.days`` in the checks the other cells' tests make: on the CPU,
cut to their size, a sound run is correct, each planted fault of
``test_portbench_faults`` (a state returned unchanged, half of the rays,
an answer altered where it is made) turns ``correct`` false, and the
control fails the cell's limits where the program passes them; on the
card (``cuda``), the control fails at the cell's own size."""

import pytest

from portbench.tests import test_portbench_control as control
from portbench.tests.test_portbench_faults import FAULTS, plant

CELL = "ref_1e7.days"


def test_a_sound_run_is_correct(tiny):
    res = tiny(CELL, seed=2**31 + 99)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_path_is_not_correct(tiny, monkeypatch, fault):
    plant(monkeypatch, fault)
    res = tiny(CELL, seed=2**31 + 99)
    assert not res["correct"], res["checks"]


def test_control_fails_and_program_passes(tiny):
    control.test_control_fails_and_program_passes(tiny, CELL)


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    control.test_control_fails_at_the_cells_size(card, CELL)
