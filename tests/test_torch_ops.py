"""The port's dispersion, interpolation and saturation against msgwam_tpu
in float64 on the same random inputs (rtol 1e-12: the same expressions,
up to a few ulps of transcendental and summation order)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgwam_tpu.ops import dispersion as jd, saturation as js
from msgwam_tpu_torch.ops import dispersion as td, interp as ti, saturation as ts

# msgwam_tpu.ops re-exports a function named ``interp`` over the module name
ji = importlib.import_module("msgwam_tpu.ops.interp")

torch.set_num_threads(1)

RTOL = 1e-12
BVF = 0.01


def _waves(rng, n=500):
    k = rng.uniform(1e-5, 1e-3, n)
    l = rng.uniform(-1e-3, 1e-3, n)
    m = rng.uniform(-1e-2, -1e-4, n)
    phi = rng.uniform(-1.2, 1.2, n)
    r = rng.uniform(0.0, 100e3, n)
    return k, l, m, phi, r


def _both(fn_j, fn_t, *args, **kw):
    a = fn_j(*(jnp.asarray(x) if isinstance(x, np.ndarray) else x
               for x in args), **kw)
    b = fn_t(*(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
               for x in args), **kw)
    return a, b


def _close(a, b, rtol=RTOL, atol=0.0):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            _close(x, y, rtol, atol)
        return
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol, atol=atol)


@pytest.mark.parametrize("phi_kind", ["per_ray", "scalar"])
def test_omega_and_cg_r(phi_kind):
    rng = np.random.default_rng(1)
    k, l, m, phi, _ = _waves(rng)
    if phi_kind == "scalar":
        phi = 0.7
    _close(*_both(jd.omega, td.omega, k, l, m, phi, BVF))
    _close(*_both(jd.cg_r, td.cg_r, k, l, m, phi, BVF))


@pytest.mark.parametrize("hprop", [False, True])
def test_group_velocities_and_refraction(hprop):
    rng = np.random.default_rng(2)
    k, l, m, phi, r = _waves(rng)
    u, v, du, dv = (rng.normal(size=k.shape) for _ in range(4))
    _close(*_both(jd.group_velocities, td.group_velocities,
                  k, l, m, phi, u, v, BVF, hprop), atol=1e-300)
    a, b = _both(jd.wavenumber_tendencies, td.wavenumber_tendencies,
                 k, l, m, phi, r, u, v, du * 1e-3, dv * 1e-3, BVF, hprop)
    # dk/dl are the difference of nearly equal terms: compare to the scale
    for x, y in zip(a, b):
        x = np.asarray(x)
        np.testing.assert_allclose(y.numpy(), x, rtol=RTOL,
                                   atol=RTOL * np.max(np.abs(x)))


@pytest.mark.parametrize("n_points", [101, 99])
def test_grid_interp_matches(n_points):
    rng = np.random.default_rng(3)
    xp = np.linspace(500.0, 99500.0, n_points)
    fp = rng.normal(size=n_points)
    # interior, outside on both sides, and exactly on the nodes
    x = np.concatenate([rng.uniform(-5e3, 105e3, 400), xp[::7]])
    a, b = _both(ji.grid_interp, ti.grid_interp, x, xp, fp)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(b.numpy(), np.interp(x, xp, fp), rtol=RTOL,
                               atol=1e-15)


@pytest.mark.parametrize("ncol", [0, 2])
def test_basis_interp_matches(ncol):
    rng = np.random.default_rng(4)
    n = 100
    x0, dx = 500.0, 1000.0
    tables = rng.normal(size=(n,) if ncol == 0 else (n, ncol))
    x = rng.uniform(-5e3, 105e3, 300)
    a, b = _both(ji.basis_interp, ti.basis_interp, x, x0, dx, tables)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=1e-14)
    Ba, Bb = _both(ji.basis_matrix, ti.basis_matrix, x, x0, dx, n)
    np.testing.assert_allclose(Bb.numpy(), np.asarray(Ba), rtol=RTOL, atol=1e-14)


def _sat_args(rng, n=600):
    k, l, m, _, r = _waves(rng, n)
    dens = np.abs(rng.lognormal(0.0, 2.0, n)) * 1e10
    dr = rng.uniform(100.0, 1000.0, n)
    r_rate = rng.normal(0.0, 1.0, n)
    m_rate = rng.normal(0.0, 1e-7, n)
    dkk = np.full(n, 1e-4)
    dll = np.full(n, 1e-4)
    area = 5e-5 * dr
    centers = np.linspace(500.0, 99500.0, 100)
    rhobar = 1.2 * np.exp(-centers / 8500.0)
    return (120.0, dens, r, r_rate, dr, 0.0, k, l, m, m_rate, dkk, dll, area,
            centers, rhobar, BVF, 1.0, 0.3)


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("backend", ["gather", "mxu"])
def test_saturation_matches(faithful, backend):
    rng = np.random.default_rng(5)
    args = _sat_args(rng)
    active = rng.random(600) > 0.1
    kw = dict(faithful=faithful, interp_backend=backend)
    for fj, ft in ((js.saturate_direct, ts.saturate_direct),
                   (js.saturation_tendency, ts.saturation_tendency)):
        a, b = _both(fj, ft, *args, active=None, **kw)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=0)
        a = fj(*(jnp.asarray(x) if isinstance(x, np.ndarray) else x
                 for x in args), active=jnp.asarray(active), **kw)
        b = ft(*(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                 for x in args), active=torch.from_numpy(active), **kw)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=0)
    # the case split is non-trivial: some rays saturate, some do not
    a = np.asarray(js.saturation_tendency(
        *(jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args)))
    assert 0 < np.count_nonzero(a) < a.size
