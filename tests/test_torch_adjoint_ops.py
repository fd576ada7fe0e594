"""The port's backwards of ``basis_interp`` and the flux deposit against
msgwam_tpu's VJPs, in float64 on the same seeded inputs: the
residual-free ``basis_interp`` backward (``ops/interp.py:_BasisInterp``)
with JAX's kink conventions at on-node queries and on both clip bounds,
and the deposit's cotangents (``project`` and ``project_dense`` in its
three accumulation modes, the ``native`` one through ``_DenseDeposit``)
with ray edges on grid faces, where the overlap is 0 and ``abs'(0)``
decides the gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgwam_tpu.ops.interp import basis_interp as jax_basis_interp
from msgwam_tpu.ops.projection import project as jax_project
from msgwam_tpu.ops.projection import project_dense as jax_project_dense
from msgwam_tpu_torch.ops.interp import basis_interp, basis_matrix
from msgwam_tpu_torch.ops.projection import project, project_dense

torch.set_num_threads(1)

RTOL = 1e-12


def _close(got, want, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=f"cotangent of {name}")


def _torch_vjp(fn, args, ct):
    ts = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    out = fn(*ts)
    out.backward(torch.tensor(ct))
    return out.detach().numpy(), [t.grad for t in ts]


QUERIES = {
    # random inside the grid
    "random": lambda rng: rng.uniform(0.3, 8.7, 40),
    # on the nodes, both clip bounds, and past them
    "nodes_and_bounds": lambda rng: np.array(
        [0.0, 1.0, 2.5, 3.0, 9.0, 4.2, -1.5, 10.25, 5.0, 8.0]),
}


@pytest.mark.parametrize("table_dim", [1, 2])
@pytest.mark.parametrize("queries", sorted(QUERIES))
def test_basis_interp_cotangents_match_jax(queries, table_dim):
    """Cotangents of x, x0, dx and the tables on a 10-node grid (x0 = 0,
    dx = 1), against ``jax.vjp`` through the JAX package's custom VJP."""
    rng = np.random.default_rng(7)
    x = QUERIES[queries](rng)
    tables = rng.standard_normal((10, 2) if table_dim == 2 else 10)
    x0, dx = np.float64(0.0), np.float64(1.0)
    out_j, vjp = jax.vjp(jax_basis_interp, jnp.asarray(x), jnp.asarray(x0),
                         jnp.asarray(dx), jnp.asarray(tables))
    ct = rng.standard_normal(out_j.shape)
    want = vjp(jnp.asarray(ct))
    out, grads = _torch_vjp(basis_interp, (x, x0, dx, tables), ct)
    np.testing.assert_allclose(out, np.asarray(out_j), rtol=1e-13, atol=1e-15)
    for g, w, name in zip(grads, want, ("x", "x0", "dx", "tables")):
        _close(g, w, name)


def test_basis_interp_gradient_of_the_probe():
    """The gradient of sum(out^2) in x at the queries [0, 1, 2.5, 3, 9,
    4.2]: torch's own rules (abs'(0) = 0, clamp passes 1 on its bounds)
    gave another gradient at every on-node query and at both clip ends."""
    rng = np.random.default_rng(0)
    tables = rng.standard_normal((10, 2))
    x = np.array([0.0, 1.0, 2.5, 3.0, 9.0, 4.2])
    want = jax.grad(lambda q: jnp.sum(jax_basis_interp(
        q, 0.0, 1.0, jnp.asarray(tables)) ** 2))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (basis_interp(xt, 0.0, 1.0, torch.tensor(tables)) ** 2).sum().backward()
    _close(xt.grad, want, "x")
    # the forward is the dense basis product, unchanged
    with torch.no_grad():
        plain = basis_matrix(xt, torch.tensor(0.0, dtype=torch.float64),
                             torch.tensor(1.0, dtype=torch.float64), 10) \
            @ torch.tensor(tables)
        assert torch.equal(basis_interp(xt, 0.0, 1.0, torch.tensor(tables)),
                           plain)


def _deposit_inputs(rng, n=400, n_points=21, top=10e3):
    """Rays on a ``n_points`` grid over [0, top] with edges on faces: the
    first quarter's lower edges and the second quarter's upper edges sit
    exactly on a face (``tests/test_projection.py:240-283``)."""
    grid = np.linspace(0.0, top, n_points)
    r = rng.uniform(0.05 * top, 0.9 * top, n)
    dr = rng.uniform(0.02 * top, 0.12 * top, n)
    rl, ru = r - 0.5 * dr, r + 0.5 * dr
    q = n // 4
    rl[:q] = grid[rng.integers(1, n_points - 4, q)]
    ru[q:2 * q] = grid[rng.integers(2, n_points - 2, q)]
    ru = np.maximum(ru, rl + 10.0)
    vals = rng.normal(0.0, 1.0, (2, n))
    pv = np.abs(rng.normal(1e-12, 1e-13, n))
    valid = rng.random(n) > 0.1
    return vals, rl, ru, pv, valid, grid


DEPOSITS = {
    "project": (lambda *a, valid: project(*a[:4], valid, a[4], max_span=4),
                lambda *a, valid: jax_project(*a[:4], valid, a[4], max_span=4)),
    **{f"project_dense_{acc}": (
        lambda *a, valid, acc=acc: project_dense(*a[:4], valid, a[4], accum=acc),
        lambda *a, valid, acc=acc: jax_project_dense(*a[:4], valid, a[4],
                                                     accum=acc))
       for acc in ("native", "f64", "compensated")},
}


@pytest.mark.parametrize("deposit", sorted(DEPOSITS))
def test_deposit_cotangents_match_jax_at_ties(deposit):
    """Cotangents of values, r_low, r_up, phase_vol and grid, with ray
    edges on grid faces; before the port took JAX's abs'(0) = 1, the r_up
    and grid cotangents were off by the size of the gradient itself."""
    rng = np.random.default_rng(11)
    vals, rl, ru, pv, valid, grid = _deposit_inputs(rng)
    ours, theirs = DEPOSITS[deposit]
    args = (vals, rl, ru, pv, grid)
    out_j, vjp = jax.vjp(lambda *a: theirs(*a, valid=jnp.asarray(valid)),
                         *map(jnp.asarray, args))
    ct = rng.standard_normal(out_j.shape)
    want = vjp(jnp.asarray(ct))
    out, grads = _torch_vjp(lambda *a: ours(*a, valid=torch.tensor(valid)),
                            args, ct)
    np.testing.assert_allclose(out, np.asarray(out_j), rtol=1e-13, atol=1e-16)
    for g, w, name in zip(grads, want,
                          ("values", "r_low", "r_up", "phase_vol", "grid")):
        _close(g, w, name)
