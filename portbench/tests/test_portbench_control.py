"""The control, the reference computed in bfloat16 in the program's place,
fails each cell's comparison, and the program's answers pass it: at a size
the CPU holds here (the program's kernels run their twins), and at the
cell's own size on the card (``cuda``; ``python -m portbench.calibrate``
reads a dozen seeds there)."""

import time

import pytest
import torch

from portbench import calibrate, check, manifest
from portbench.tests.conftest import REPO

CELLS = ["ref_1e6.days", "ref_1e6.per_step", "tidal_1e5.days",
         "tidal_1e5.per_step", "ens8_125k.days"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(tiny, cell):
    c = manifest.load(tiny.root, cell, tiny.root / "pb")
    for seed in (3, 2**31 + 17):
        r = calibrate.readings(c, seed, 0.3, True, torch.device("cpu"))
        assert check.verdict(r["program"], c.limits["limits"])[0], r
        assert not check.verdict(r["control"], c.limits["limits"])[0], r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    c = manifest.load(REPO, cell)
    for seed in (11, 12, 13):
        t0 = time.perf_counter()
        r = calibrate.readings(c, seed, 1.0, True, card)
        assert check.verdict(r["program"], c.limits["limits"])[0], r
        assert not check.verdict(r["control"], c.limits["limits"])[0], r
        assert time.perf_counter() - t0 < 300
