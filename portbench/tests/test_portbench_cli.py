"""The ``cli_run`` mix on the CPU at 2048 rays and four frames a request
(the program's kernels run their plain twins there): the caller's
read-back is the program's own run, bit for bit; the harness's reader of
the streamed history agrees with the program's; ``diag_gap`` reads the
program's diagnostics as the reference deposits them; and ``correct``
comes out false, or a request counts as failed, when the driver's path
is broken underneath the harness."""

import json
import time

import numpy as np
import pytest
import torch

import msgwam_tpu_torch as prog
from msgwam_tpu_torch import cli, diagnostics
from msgwam_tpu_torch.utils import history_io
from portbench import calibrate, check, cli_run, manifest, run, traffic
from portbench.tests.conftest import REPO, tiny_copy

CELL = "ref_1e6.cli_run"
# the cell as a manifest would name it: BENCHMARK.json holds it back until
# its rate is steady, and these tests add it to their own copy
WORKLOAD = {"name": CELL, "config": "ref_1e6", "traffic": "cli_run", "chips": 1,
            "why": "the experiment driver, K1 and the history writer"}
N_RAY = 2048
SEED = 2**31 + 41
CPU = torch.device("cpu")


@pytest.fixture
def root(tmp_path):
    """A cut copy of the benchmark: ``ref_1e6`` at ``N_RAY`` rays, a
    request of four frames of 18 steps, request 0's first frame judged."""
    root = tiny_copy(tmp_path)
    conf_path = root / "pb/configs/ref_1e6.json"
    conf = json.loads(conf_path.read_text())
    conf["n_ray"] = N_RAY
    conf_path.write_text(json.dumps(conf))
    path = root / "pb/traffic/cli_run.json"
    mix = json.loads(path.read_text())
    mix.update(steps_per_request=72, save_every=18, restart_every=72,
               trace_requests=1, check={"requests": 1, "within": 3, "launches": 2})
    path.write_text(json.dumps(mix))
    with_cell(root)
    return root


def with_cell(root):
    """``root/BENCHMARK.json`` with the cell added."""
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append(WORKLOAD)
    (root / "BENCHMARK.json").write_text(json.dumps(m))


def cell_of(root):
    return manifest.load(root, CELL, root / "pb")


def go(root, seconds=0.0) -> dict:
    return run.run_cell(cell_of(root), SEED, seconds, False, CPU, time.time(),
                        root / "pb")


@pytest.fixture
def served(root):
    """A driver of the cut cell that has served request 0 (sampled)."""
    c = cell_of(root)
    s = traffic.setup(c.config, SEED, CPU)
    driver = traffic.Driver(s, c.traffic, SEED)
    ans = driver.verify(driver.request(0))
    yield s, driver, ans
    driver.close()


def test_the_read_back_is_the_programs_run_bit_for_bit(served):
    s, driver, ans = served
    assert not ans.failed and [it.step0 for it in ans.items] == [0]
    spec = driver.cli.spec
    cfg = prog.ModelConfig(dtype=spec["dtype"], **spec["model"])
    final, statics, (h, active, _) = prog.simulate_resident(
        s.state0, s.statics0, s.bg, cfg, driver.run)
    back = driver.cli.history()
    assert back.whole and back.frames == driver.n_launches == 4
    for f in range(back.frames):
        for name in ("dens", "lam", "phi", "r", "dr", "k", "l", "m", "dm"):
            assert np.array_equal(back.field(f, name),
                                  getattr(h.rays, name)[f].numpy()), (f, name)
        assert np.array_equal(back.field(f, "active"), active[f].numpy())
        assert np.array_equal(back.field(f, "u"), h.mean.u[f].numpy())
        assert np.array_equal(back.field(f, "v"), h.mean.v[f].numpy())
    assert torch.equal(ans.host, torch.stack([h.mean.u, h.mean.v]))
    item = ans.items[0]
    assert all(torch.equal(a, b[0]) for a, b in zip(
        item.rays_out, (h.rays.dens, h.rays.r, h.rays.m, active)))


def test_the_history_reader_agrees_with_the_programs(served):
    s, driver, _ = served
    back = driver.cli.history()
    theirs = history_io.read_state_history(back.path)
    assert set(theirs) == set(back.offsets)
    for name, x in theirs.items():
        assert x.shape[0] == back.frames
        for f in range(back.frames):
            assert np.array_equal(back.field(f, name), x[f]), (f, name)


def test_diag_gap_reads_the_float64_diagnostics_as_the_reference():
    conf = json.loads((REPO / "portbench/configs/ref_1e6.json").read_text())
    conf = dict(conf, n_ray=N_RAY, model=dict(
        conf["model"], dtype="float64", projection_backend="xla"))
    s = traffic.setup(conf, SEED, CPU)
    cfg = prog.ModelConfig(**conf["model"])
    d = lambda x: x.to(torch.float64)
    rays = s.state0.rays._replace(**{f: d(getattr(s.state0.rays, f))
                                     for f in s.state0.rays._fields})
    # spread the rays over the column, so that both grids' cells fill
    rays = rays._replace(r=rays.r + torch.linspace(0.0, 9e4, N_RAY,
                                                   dtype=torch.float64))
    statics = s.statics0._replace(dkk=d(s.statics0.dkk), dll=d(s.statics0.dll),
                                  rr_mm_area=d(s.statics0.rr_mm_area))
    bg = prog.Background(*(d(x) for x in s.bg))
    stack = lambda t: type(t)(*(x[None] for x in t))
    diag = diagnostics.wave_action_history(
        stack(rays), statics.active[None], statics, bg, cfg)
    out = (rays.dens, rays.r, rays.m, statics.active)
    item = traffic.Item(0, 1, out, (s.u0, s.v0), out, (s.u0, s.v0),
                        (diag.wave_action[0], diag.flux[0]))
    assert (diag.wave_action[0] > 0).sum() > 50 and (diag.flux[0] != 0).sum() > 50
    assert check.diag_gap(item, s) < 1e-10
    assert check.diag_gap(item, s, control=True) > 1e-3


def test_diag_gap_takes_the_cells_as_the_rays_are_stored():
    """Float32 rays whose upper edge lies within a few float32 roundings
    of a multiple of ``dz``: the index rule moves half a center-grid cell
    of such a ray's flux, so edges and cells worked out in float64 would
    read the program's float32 diagnostics as far off; the reference
    works them out in the rays' float32 and sums in float64."""
    from portbench.reference import diagnostics as ref_diag

    conf = json.loads((REPO / "portbench/configs/ref_1e6.json").read_text())
    conf = dict(conf, n_ray=N_RAY, model=dict(conf["model"],
                                              projection_backend="pallas"))
    s = traffic.setup(conf, SEED, CPU)
    cfg = prog.ModelConfig(**conf["model"])
    dz = float(s.bg.centers[1] - s.bg.centers[0])
    g = torch.Generator().manual_seed(3)
    faces = dz * torch.randint(3, 90, (N_RAY,), generator=g).double()
    nudge = torch.randint(-3, 4, (N_RAY,), generator=g).double() * 2.0**-9
    r = (faces - 0.5 * s.pop.dr + nudge).float()
    rays = s.state0.rays._replace(r=r)
    active = s.statics0.active
    stack = lambda t: type(t)(*(x[None] for x in t))
    diag = diagnostics.wave_action_history(stack(rays), active[None],
                                           s.statics0, s.bg, cfg)
    out = (rays.dens, rays.r, rays.m, active)
    item = traffic.Item(0, 1, out, (s.u0, s.v0), out, (s.u0, s.v0),
                        (diag.wave_action[0], diag.flux[0]))
    assert check.diag_gap(item, s) < 1e-5
    p, col, fz, _, _ = check._parts(s, torch.float64)
    wide = ref_diag.wave_action(check._rays(out, s, torch.float64), fz, col,
                                p.bvf)[1]
    assert float((diag.flux[0].double() - wide).abs().max()
                 / wide.abs().max()) > 1e-3


def test_the_output_directory_is_fixed_emptied_and_refused_when_short(
        monkeypatch, tmp_path):
    monkeypatch.setattr(cli_run, "MEMORY", tmp_path / "shm")
    (tmp_path / "shm").mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp_path / "a"))
    (tmp_path / "a").mkdir()
    monkeypatch.setattr(cli_run.tempfile, "tempdir", None)
    first = cli_run.output_dir(1)
    (first / "left.msgw").write_bytes(b"x")
    again = cli_run.output_dir(1)
    # a run of the same side finds the same directory, emptied
    assert again == first and not any(again.iterdir())
    monkeypatch.setenv("TMPDIR", str(tmp_path / "b"))
    (tmp_path / "b").mkdir()
    monkeypatch.setattr(cli_run.tempfile, "tempdir", None)
    other = cli_run.output_dir(1)
    # the other side of a comparison has its own
    assert other != first and other.parent == first.parent == tmp_path / "shm"
    with pytest.raises(RuntimeError, match="needs"):
        cli_run.output_dir(1 << 62)


def test_a_sound_run_is_correct(root):
    res = go(root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"flux_gap", "wind_gap", "rays_off", "diag_gap",
                                  "failed_requests"}


def test_the_control_fails_and_the_program_passes(root):
    c = cell_of(root)
    r = calibrate.readings(c, SEED, 0.0, True, CPU)
    assert r["failed"] == 0
    assert check.verdict(r["program"], c.limits["limits"])[0], r
    assert not check.verdict(r["control"], c.limits["limits"])[0], r
    assert r["control"]["diag_gap"] > c.limits["limits"]["diag_gap"], r


def _scaled(t, fault):
    """``t`` (a RayState) with ``fault`` applied to every slot."""
    if fault == "altered":
        return t._replace(dens=t.dens * 1.01)
    h = t.dens.shape[-1] // 2
    twice = lambda x: torch.cat([x[..., :h], x[..., :h]], dim=-1)
    return t._replace(dens=twice(t.dens), r=twice(t.r), m=twice(t.m))


def plant(monkeypatch, fault):
    """Break the driver's path where ``fault`` is made: in the whole-run
    kernel's answer (``unchanged``, ``half``, ``altered``: the final state
    and its frames alike), in the history writer (``dropped``: the second
    frame never written; ``record``: 1% on the first record's densities),
    in the diagnostics (``flux``: 1% on the flux) or in the final
    checkpoint (``final``: 1% on its densities)."""
    real = cli.simulate_resident

    def resident(state, statics, *a, **kw):
        final, st, (h, active, prop) = real(state, statics, *a, **kw)
        if fault == "unchanged":
            final = state
            h = prog.State(type(state.rays)(*(x[None] for x in state.rays)),
                           type(state.mean)(*(x[None] for x in state.mean)))
        elif fault in ("half", "altered"):
            final = final._replace(rays=_scaled(final.rays, fault))
            h = h._replace(rays=_scaled(h.rays, fault))
        return final, st, (h, active, prop)

    writer = history_io.StateHistoryWriter
    push = writer.push_frame

    def push_frame(self, rays, active, dens_prop, mean):
        self.pushed = getattr(self, "pushed", 0) + 1
        if fault == "dropped" and self.pushed == 2:
            return
        if fault == "record" and self.pushed == 1:
            rays = rays._replace(dens=rays.dens * 1.01)
        push(self, rays, active, dens_prop, mean)

    real_diag = cli.wave_action_history

    def wave_action_history(*a, **kw):
        d = real_diag(*a, **kw)
        return d._replace(flux=d.flux * 1.01) if fault == "flux" else d

    real_save = cli.save_checkpoint

    def save_checkpoint(path, state, statics, **kw):
        if fault == "final":
            state = state._replace(rays=state.rays._replace(
                dens=state.rays.dens * 1.01))
        real_save(path, state, statics, **kw)

    monkeypatch.setattr(cli, "simulate_resident", resident)
    monkeypatch.setattr(writer, "push_frame", push_frame)
    monkeypatch.setattr(cli, "wave_action_history", wave_action_history)
    monkeypatch.setattr(cli, "save_checkpoint", save_checkpoint)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "dropped",
                                   "record", "flux", "final"])
def test_a_broken_path_is_not_correct(root, monkeypatch, fault):
    plant(monkeypatch, fault)
    res = go(root)
    assert not res["correct"], res["checks"]
    if fault in ("dropped", "final"):
        assert res["failed"] == res["attempted"], res


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card, tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    (tmp_path / "portbench").symlink_to(REPO / "portbench")
    with_cell(tmp_path)
    c = manifest.load(tmp_path, CELL)
    for seed in (11, 12, 13):
        t0 = time.perf_counter()
        r = calibrate.readings(c, seed, 2.0, True, card)
        assert r["failed"] == 0
        assert check.verdict(r["program"], c.limits["limits"])[0], r
        assert not check.verdict(r["control"], c.limits["limits"])[0], r
        assert time.perf_counter() - t0 < 300
