"""The port's dry run (``msgwam_tpu_torch.dryrun``) against
``__graft_entry__``: ``entry()``'s step against JAX's on the same inputs
(1e-5 relative to the maximum); ``dryrun_multichip`` with 2 and 4 gloo
ranks on the CPU prints the two OK lines; the 2-rank sharded step within
1e-6 of the unsharded port step (the JAX dry run only checks that its
result is finite); the mega leg's members against their own single-process
runs.  Each dry run's ranks have their own timeout
(``dryrun.WORKER_TIMEOUT_S``)."""

import contextlib
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch import dryrun
from msgwam_tpu_torch.parallel import ensemble_simulate

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY_BAR = 1e-5
SHARD_BAR = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30))


def test_dryrun_imports_without_jax():
    code = ("import sys\n"
            "for m in ('jax', 'optax', 'msgwam_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import msgwam_tpu_torch.dryrun\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_entry_matches_graft_entry():
    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    jfn, (jstate, jstatics) = g.entry()
    want_state, want_statics = jax.jit(jfn)(jstate, jstatics)
    fn, (state, statics) = dryrun.entry("cpu")
    # the port's builders make the JAX entry's inputs to a few float32
    # roundings; the step runs on the JAX entry's own
    for f in ("dens", "r", "m"):
        assert _rel(getattr(jstate.rays, f), getattr(state.rays, f)) < 1e-6, f
    assert _rel(jstate.mean.u, state.mean.u) < 1e-6
    state = mtt.from_numpy(jstate, device="cpu")
    statics = mtt.from_numpy(jstatics, device="cpu")
    got_state, got_statics = fn(state, statics)
    assert got_state.rays.dens.shape == (8192,)
    for f in mtt.RayState._fields:
        assert _rel(getattr(want_state.rays, f), getattr(got_state.rays, f)) \
            < ENTRY_BAR, f
    assert _rel(want_state.mean.u, got_state.mean.u) < ENTRY_BAR
    np.testing.assert_array_equal(np.asarray(want_statics.active),
                                  got_statics.active.numpy())


def test_main_runs_entry_on_the_cpu(capsys):
    dryrun.main(["--device", "cpu"])
    assert "entry() run OK on cpu" in capsys.readouterr().out


def test_main_without_device_names_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)


def _dryrun(n):
    """``(result, printed)`` of one dry run of ``n`` ranks."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = dryrun.dryrun_multichip(n, device="cpu")
    return res, out.getvalue()


@pytest.fixture(scope="module")
def runs():
    """The dry runs of 2 and 4 ranks, once per module."""
    return {n: _dryrun(n) for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_prints_ok_lines(n, runs):
    res, out = runs[n]
    assert "dryrun_multichip OK" in out
    assert "dryrun_multichip mega-ensemble OK" in out
    e, r = dryrun.mesh_shape(n)
    assert res["mesh"] == (e, r) == ((1, 2) if n == 2 else (2, 2))
    assert res["state"].rays.r.shape == (e, dryrun.PER_SHARD * r)
    assert res["mega_final"].rays.dens.shape == (n, dryrun.N_MEGA)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_matches_unsharded(n, runs):
    """Each member's step over its ray ranks against the unsharded port
    step of the same rays (the sums over ranks take another order)."""
    res = runs[n][0]
    e, r = dryrun.mesh_shape(n)
    cfg, bg, state, statics = dryrun.setup(dryrun.PER_SHARD * r, device="cpu")
    want, want_st, _ = mtt.step(dryrun.DT, state, statics, bg, cfg)
    for m in range(e):
        for f in mtt.RayState._fields:
            assert _rel(getattr(want.rays, f),
                        getattr(res["state"].rays, f)[m]) < SHARD_BAR, (m, f)
        assert _rel(want.mean.u, res["state"].mean.u[m]) < SHARD_BAR
        assert torch.equal(want_st.active, res["statics"].active[m])


@pytest.mark.parametrize("n", [2, 4])
def test_mega_leg_matches_one_process(n, runs):
    """The second leg's members, one a rank, against the same ensemble in
    one process (``ensemble_simulate(backend="mega")`` without a mesh: K7's
    twin on the CPU)."""
    res = runs[n][0]
    cfg, bg, _, _ = dryrun.setup(dryrun.PER_SHARD, device="cpu")
    states, statics = dryrun.mega_members(cfg, bg, n)
    run = mtt.RunConfig(dt=dryrun.DT, n_steps=2, save_every=2)
    fin, _, mh = ensemble_simulate(states, statics, bg, cfg, run,
                                   backend="mega")
    assert _rel(fin.rays.dens, res["mega_final"].rays.dens) < SHARD_BAR
    assert _rel(fin.rays.r, res["mega_final"].rays.r) < SHARD_BAR
    assert _rel(mh.u, res["mega_mean"].u) < SHARD_BAR
