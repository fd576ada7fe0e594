"""The port's libprop shim (msgwam_tpu_torch.api) against msgwam_tpu.api
on the cases of tests/test_api.py: the import-time defaults, RK3 and
rhs_default in float64 at rtol 1e-12 with hprop on and off, the custom
``rhs`` injection point, wave_projection var 0-4 and the full-shape
contract."""

import numpy as np
import pytest

import msgwam_tpu.api as jshim
import msgwam_tpu_torch.api as tshim

SHIMS = (jshim, tshim)


@pytest.fixture(autouse=True)
def fresh_shim_state():
    """Reset both shims' module state around each test; the port's runs on
    the CPU."""
    saved = [(dict(m.model_config), dict(m.statics), m.HPROP_GLOBAL, m.grid,
              m.grids, m.rhobar, m.pressure_gradient) for m in SHIMS]
    tshim.DEVICE = "cpu"
    yield
    tshim.DEVICE = None
    for m, (mc, st, hprop, grid, grids, rhobar, pg) in zip(SHIMS, saved):
        m.model_config.clear()
        m.model_config.update(mc)
        m.statics.clear()
        m.statics.update(st)
        (m.HPROP_GLOBAL, m.grid, m.grids, m.rhobar,
         m.pressure_gradient) = hprop, grid, grids, rhobar, pg


def _driver_setup(lprop, nray=60):
    """The reference driver's setup block against a libprop-like module."""
    NN, phi0 = 0.01, 0.0
    lprop.HPROP_GLOBAL = False
    lprop.set_model_setup(
        bvf=NN, rhs=lprop.rhs_default, boussinesq=False, sig_rr=10000,
        u0=4, rr0=40000, rr1=40000, phi0=phi0, kappa=1.0,
        saturate_online=False,
    )
    grid = np.linspace(0, 100e3, 101)
    grids = 0.5 * (grid[:-1] + grid[1:])
    lprop.grid, lprop.grids = grid, grids
    k_abs = 2 * np.pi / 50e3
    kk = np.ones(nray) * k_abs
    ll = np.zeros(nray)
    mm = np.ones(nray) * -2 * np.pi / 5e3
    edges = np.linspace(0, 15000, nray + 1)
    rr = 0.5 * (edges[:-1] + edges[1:])
    drr = np.full(nray, edges[1] - edges[0])
    area = 5e-5 * drr
    dmm = area / drr
    uu = lprop.velocities_sine_homogeneous(grids)
    vv = np.zeros_like(uu)
    lprop.set_hydrostatics()
    lprop.set_pressure_gradient(uu, vv)
    dkk = np.ones(nray) * 1e-4
    dll = np.ones(nray) * 1e-4
    lprop.set_statics(dll=dll, dkk=dkk, rr_mm_area=area)
    rhobar_ray = np.interp(rr, grids, lprop.rhobar)
    omh = lprop.omega(kk, ll, mm, phi0)
    dens = (
        0.01**2 * rhobar_ray / 2 * omh / mm**2 / omh**2 * NN**2
        * np.exp(-((rr - rr.mean()) ** 2) / 2 / 2000**2)
    ) / 1e-4 / 1e-4 / dmm
    return np.array([dens, np.zeros(nray), np.full(nray, phi0), rr, drr,
                     kk, ll, mm, dmm, uu, vv], dtype=object)


def _fields_close(ours, ref, rtol=1e-12, atol=0.0):
    for i in range(len(ref)):
        np.testing.assert_allclose(
            np.asarray(ours[i], dtype=float), np.asarray(ref[i], dtype=float),
            rtol=rtol, atol=atol, err_msg=f"state field {i}")


def test_shim_defaults_match_msgwam_tpu():
    """The import-time defaults (lib/libprop.py:703-726) are msgwam_tpu's,
    the RHS entry the shim's own."""
    for key, val in jshim.model_config.items():
        if key != "rhs":
            assert tshim.model_config[key] == val, key
    assert tshim.model_config["rhs"] is tshim.rhs_default
    assert tshim.statics == jshim.statics == {"int_dll": 1, "int_dkk": 1,
                                              "rr_mm_area": 0}


@pytest.mark.parametrize("hprop", [False, True])
def test_rk3_trajectory_matches_msgwam_tpu(hprop):
    """Five RK3 steps of the reference driver's state (with hprop at a
    mid-latitude: Coriolis and all horizontal terms active)."""
    states = []
    for m in SHIMS:
        state = _driver_setup(m)
        if hprop:
            m.HPROP_GLOBAL = True
            m.set_model_setup(phi0=np.deg2rad(-45))
            m.set_hydrostatics()
            state[2] = state[2] + np.deg2rad(-45)
        for _ in range(5):
            state = m.RK3(120.0, state)
        states.append(state)
    _fields_close(states[1], states[0], atol=1e-300)


@pytest.mark.parametrize("hprop", [False, True])
def test_rhs_default_matches_msgwam_tpu(hprop):
    """rhs_default on random states (spherical metric terms, df2/dphi and
    cg_lambda/cg_phi advection with hprop on), and every field a
    full-length array."""
    for m in SHIMS:
        _driver_setup(m)
        m.HPROP_GLOBAL = hprop
        m.set_model_setup(saturate_online=False)
    rng = np.random.default_rng(11)
    n = 60
    for trial in range(3):
        var = np.array([
            np.abs(rng.normal(size=n)) * 1e9,          # dens
            rng.uniform(-0.1, 0.1, n),                  # lam
            rng.uniform(-1.2, 1.2, n),                  # phi
            rng.uniform(1e3, 99e3, n),                  # rr
            rng.uniform(100, 1500, n),                  # drr
            rng.uniform(1e-5, 1e-3, n),                 # kk
            rng.uniform(-1e-3, 1e-3, n),                # ll
            rng.uniform(-1e-2, -1e-4, n),               # mm
            np.abs(rng.normal(size=n)) * 1e-4,          # dmm
            rng.normal(size=100) * 10,                  # uu
            rng.normal(size=100) * 5,                   # vv
        ], dtype=object)
        ours = tshim.rhs_default(120.0, var)
        _fields_close(ours, jshim.rhs_default(120.0, var), atol=1e-300)
        for i in range(9):
            assert np.shape(ours[i]) == (n,), i
        assert np.shape(ours[9]) == np.shape(ours[10]) == (100,)


def test_custom_rhs_extension_point():
    """model_config['rhs'] injection (lib/libprop.py:691): RK3 runs the
    generic object-array stage arithmetic over a user-supplied RHS."""
    calls = []

    def my_rhs(dt, var):
        calls.append(dt)
        return np.array([np.full_like(np.asarray(v, dtype=float), 1e-3)
                         for v in var], dtype=object)

    outs = []
    for m in SHIMS:
        m.set_model_setup(rhs=my_rhs)
        var = np.array([np.ones(4), np.zeros(4)], dtype=object)
        outs.append(m.RK3(60.0, var))
    assert len(calls) == 6
    _fields_close(outs[1], outs[0])


def test_saturation_and_physics_functions_match_msgwam_tpu():
    for m in SHIMS:
        _driver_setup(m)
    rng = np.random.default_rng(7)
    n = 40
    kk = rng.uniform(1e-5, 1e-3, n)
    ll = rng.uniform(-1e-3, 1e-3, n)
    mm = rng.uniform(-1e-2, -1e-4, n)
    phi = np.full(n, 0.2)
    rr = rng.uniform(0, 100e3, n)
    lam = np.zeros(n)
    uu = jshim.velocities_sine_homogeneous(jshim.grids)
    vv = np.sin(jshim.grids / 7e3)
    args = (kk, ll, mm, lam, phi, rr, uu, vv)
    for hprop in (False, True):
        for m in SHIMS:
            m.HPROP_GLOBAL = hprop
        for fn, a in (("omega", (kk, ll, mm, phi)),
                      ("cg_rr", args[:6]), ("cg_lambda", args),
                      ("cg_phi", args), ("dk_dt", args), ("dl_dt", args),
                      ("dm_dt", args), ("gradients", (lam, phi, rr, uu, vv)),
                      ("velocities_sine_homogeneous", (rr,)),
                      ("velocities_tanh_homogeneous", (rr,)),
                      ("velocities_gauss_homogeneous", (rr,)),
                      ("velocities_tanh", (lam, phi - 1.2, rr))):
            want = getattr(jshim, fn)(*a)
            got = getattr(tshim, fn)(*a)
            assert np.shape(got) == np.shape(want), fn
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300,
                                       err_msg=f"{fn} hprop={hprop}")
    flux = rng.normal(size=100)
    for fn, a in (("du_dt", (vv, flux)), ("dv_dt", (uu, flux))):
        np.testing.assert_allclose(getattr(tshim, fn)(*a),
                                   getattr(jshim, fn)(*a), rtol=1e-12)

    state = _driver_setup(tshim)
    out = tshim.RK3(120.0, state)
    rr_prev, drr_prev, mm_prev = state[3], state[4], state[7]
    sat = (120.0, out[0], rr_prev, (out[3] - rr_prev) / 1,
           drr_prev, (out[4] - drr_prev) / 120.0,
           out[5], out[6], mm_prev, (out[7] - mm_prev) / 120.0)
    for direct in (True, False):
        np.testing.assert_allclose(
            tshim.saturation(*sat, direct=direct),
            jshim.saturation(*sat, direct=direct), rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("var", range(5))
def test_wave_projection_matches_msgwam_tpu(var):
    for m in SHIMS:
        _driver_setup(m)
    rng = np.random.default_rng(7)
    n = 40
    kk = rng.uniform(1e-5, 1e-3, n)
    ll = rng.uniform(-1e-3, 1e-3, n)
    mm = rng.uniform(-1e-2, -1e-4, n)
    phi = np.full(n, 0.2)
    rr = rng.uniform(0, 100e3, n)
    dens = np.abs(rng.normal(size=n)) * 1e9
    dr = rng.uniform(100, 2000, n)
    dmm = np.abs(rng.normal(size=n)) * 1e-4
    args = (dens, np.zeros(n), phi, rr - dr / 2, rr + dr / 2, kk, ll,
            mm - dmm / 2, mm + dmm / 2, np.full(n, 1e-4), np.full(n, 1e-4),
            dmm, jshim.grids)
    want = jshim.wave_projection(*args, var=var)
    got = tshim.wave_projection(*args, var=var)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(want)))
