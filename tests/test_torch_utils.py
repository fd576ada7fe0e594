"""The port's utilities against msgwam_tpu.utils: checkpoints (with a
torch.Generator, and across the two packages), the metrics logger, the
trace exporter, the streamed history files (the native writer built with g++
and the Python thread; files of either package read by the other) and the
plots."""

import json
import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msgwam_tpu_torch as mtt
from msgwam_tpu.utils import checkpoint as jckpt, history_io as jhio
from msgwam_tpu_torch.utils import checkpoint as tckpt, history_io as thio
from msgwam_tpu_torch.utils.metrics import MetricsLogger
from msgwam_tpu_torch.utils.profiling import trace

torch.set_num_threads(1)


def _port_state(n=24):
    cfg = mtt.REFERENCE_RUN_CONFIG
    gc = mtt.GridConfig()
    centers = torch.from_numpy(gc.centers())
    uu = mtt.velocities_sine_homogeneous(centers, cfg)
    bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu), device="cpu")
    rays, statics = mtt.wave_packet_ic(gc, cfg, bg, n_ray=n, device="cpu")
    statics = statics._replace(active=torch.arange(n) % 5 != 0)
    return mtt.State(rays, mtt.MeanState(uu, torch.zeros_like(uu))), statics


def _assert_tree_equal(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_checkpoint_round_trip_with_generator(tmp_path):
    """State, statics (the mask included), step, extra and a Generator
    mid-stream come back; the restored Generator continues the draws."""
    state, statics = _port_state()
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    path = tmp_path / "c.npz"
    tckpt.save_checkpoint(path, state, statics, step=17, generator=gen,
                          extra={"spec": {"a": 1}})
    want = torch.rand(4, generator=gen)
    s2, st2, step, gen2, extra = tckpt.load_checkpoint(path, device="cpu")
    _assert_tree_equal((state, statics), (s2, st2))
    assert st2.active.dtype == torch.bool
    assert step == 17 and extra == {"spec": {"a": 1}}
    assert gen2.device == torch.device("cpu")
    torch.testing.assert_close(torch.rand(4, generator=gen2), want,
                               rtol=0, atol=0)
    tckpt.save_checkpoint(path, state, statics)
    assert tckpt.load_checkpoint(path, device="cpu")[3] is None


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint written by msgwam_tpu (with its key) loads in the port
    (the generator is None), and one the port writes (with a Generator)
    loads in msgwam_tpu; the arrays are equal either way."""
    state, statics = _port_state()
    jstate, jstatics = mtt.to_numpy(state), mtt.to_numpy(statics)
    jtree = jax.tree.map(jnp.asarray, (jstate, jstatics))
    path = tmp_path / "jax.npz"
    jckpt.save_checkpoint(path, *jtree, step=9, key=jax.random.key(1),
                          extra={"by": "jax"})
    s, st, step, gen, extra = tckpt.load_checkpoint(path, device="cpu")
    _assert_tree_equal(jtree, (s, st))
    assert (step, gen, extra) == (9, None, {"by": "jax"})

    path = tmp_path / "torch.npz"
    tckpt.save_checkpoint(path, state, statics, step=4,
                          generator=torch.Generator().manual_seed(0),
                          extra={"by": "torch"})
    s, st, step, key, extra = jckpt.load_checkpoint(path)
    _assert_tree_equal((state, statics), (s, st))
    assert (step, key, extra) == (4, None, {"by": "torch"})


def test_metrics_logger_cadence_and_jsonl(tmp_path, caplog):
    path = tmp_path / "metrics.jsonl"
    logger = MetricsLogger(100, every=25, jsonl_path=str(path))
    with caplog.at_level(logging.INFO, logger="msgwam_tpu_torch"):
        for step in range(1, 101):
            logger.record(step, max_u=1.5 * step)
    logger.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [line["step"] for line in lines] == [25, 50, 75, 100]
    assert lines[-1]["progress"] == 1.0
    assert lines[0]["max_u"] == 1.5 * 25
    assert all("steps_per_sec" in line for line in lines)
    assert len(caplog.records) == 4


def test_trace(tmp_path):
    """The exported Chrome trace holds the program's span of a ``simulate``
    call made inside the block."""
    state, statics = _port_state()
    cfg = mtt.REFERENCE_RUN_CONFIG
    bg = mtt.make_background(mtt.GridConfig(), cfg, state.mean.u, state.mean.v,
                             device="cpu")
    with trace(str(tmp_path)) as prof:
        mtt.simulate(state, statics, bg, cfg,
                     mtt.RunConfig(dt=120.0, n_steps=2, save_every=1))
    assert prof is not None
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "msgwam.simulate" for e in events)
    with trace() as none:
        assert none is None


@pytest.fixture(params=[True, False], ids=["native", "python"])
def native(request):
    if request.param and shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native writer cannot build")
    return request.param


def test_history_writer_round_trip(tmp_path, native):
    p = tmp_path / "hist.msgw"
    rng = np.random.default_rng(0)
    recs = [rng.random((3, 64)).astype(np.float32) for _ in range(40)]
    w = thio.HistoryWriter(p, (3, 64), np.float32, max_queue=4, native=native)
    assert (w._lib is not None) == native
    for i, r in enumerate(recs):
        w.push(torch.from_numpy(r) if i % 2 else r)
    assert w.close() == 40
    back = thio.read_history(p)
    np.testing.assert_array_equal(back, np.stack(recs))
    np.testing.assert_array_equal(jhio.read_history(p), back)
    with pytest.raises(ValueError):
        w.push(recs[0])


def test_state_history_writer_round_trip(tmp_path, native):
    """Frames of tensors (the port's history) round-trip; a wrong-sized
    field is refused."""
    state, statics = _port_state()
    p = tmp_path / "state.msgw"
    frames = []
    with thio.StateHistoryWriter(p, capacity=24, n_cell=100,
                                 dtype=np.float64, native=native) as w:
        for i in range(3):
            rays = state.rays._replace(r=state.rays.r + 10.0 * i)
            prop = rays.dens * 0.5
            w.push_frame(rays, statics.active, prop, state.mean)
            frames.append((rays, prop))
        with pytest.raises(ValueError, match="expected 100"):
            w.push_frame(rays, statics.active, prop,
                         state.mean._replace(u=state.mean.u[:50]))
    back = thio.read_state_history(p)
    jback = jhio.read_state_history(p)
    assert back["dens"].shape == (3, 24) and back["u"].shape == (3, 100)
    for t, (rays, prop) in enumerate(frames):
        for name in thio._RAY_FIELDS[:9]:
            np.testing.assert_array_equal(back[name][t],
                                          getattr(rays, name).numpy())
        np.testing.assert_array_equal(back["dens_prop"][t], prop.numpy())
        np.testing.assert_array_equal(back["active"][t],
                                      statics.active.numpy())
        np.testing.assert_array_equal(back["u"][t], state.mean.u.numpy())
    for name in back:
        np.testing.assert_array_equal(back[name], jback[name])


def test_reads_a_file_written_by_msgwam_tpu(tmp_path):
    """The MSGW v1 format is the same byte for byte: msgwam_tpu's state
    history reads back through the port, and the port writes the same
    bytes for the same frame."""
    state, statics = _port_state()
    jrays = jax.tree.map(jnp.asarray, mtt.to_numpy(state.rays))
    jmean = jax.tree.map(jnp.asarray, mtt.to_numpy(state.mean))
    act, prop = statics.active.numpy(), state.rays.dens.numpy() * 2.0
    pj, pt = tmp_path / "j.msgw", tmp_path / "t.msgw"
    with jhio.StateHistoryWriter(pj, 24, 100, np.float32, native=False) as w:
        w.push_frame(jrays, act, prop, jmean)
    with thio.StateHistoryWriter(pt, 24, 100, np.float32, native=False) as w:
        w.push_frame(state.rays, statics.active, torch.from_numpy(prop),
                     state.mean)
    assert pj.read_bytes() == pt.read_bytes()
    assert json.loads(pj.with_name("j.msgw.json").read_text()) == \
        json.loads(pt.with_name("t.msgw.json").read_text())
    back = thio.read_state_history(pj)
    np.testing.assert_array_equal(back["dens"][0], np.float32(
        state.rays.dens.numpy()))
    np.testing.assert_array_equal(back["active"][0], act)


def test_plotting_smoke(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    from msgwam_tpu_torch.plotting import (plot_wave_action_panels,
                                           plot_wind_evolution)

    t = np.linspace(0, 86400, 20)
    z = np.linspace(500, 99500, 100)
    rng = np.random.default_rng(0)
    plot_wave_action_panels(t, z, rng.random((20, 100)),
                            rng.normal(size=(20, 100)) * 1e-3, show=False,
                            save_path=tmp_path / "p.png")
    assert (tmp_path / "p.png").exists()
    plot_wind_evolution(t, z, rng.normal(size=(20, 100)), show=False,
                        save_path=tmp_path / "w.png")
    assert (tmp_path / "w.png").exists()
