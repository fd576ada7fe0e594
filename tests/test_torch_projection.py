"""The port's projection backends and the K1 deposit kernel's twin against
msgwam_tpu on the same random rays (the population of
tests/test_projection.py: interior, straddling the edges, out of domain)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msgwam_tpu.ops import projection as jp
from msgwam_tpu.ops.projection_pallas import project_pallas as jax_project_pallas
from msgwam_tpu_torch.ops import projection as tp, projection_cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, for the tests that run a CUDA kernel; they skip without
    one (decided here, at run time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _random_rays(rng, n, grid_max=100e3):
    r = rng.uniform(-10e3, grid_max + 10e3, n)
    dr = rng.uniform(10.0, 2500.0, n)
    vals = rng.normal(size=(2, n))
    pv = np.abs(rng.normal(size=n))
    valid = rng.random(n) > 0.1
    return vals, r - dr / 2, r + dr / 2, pv, valid


def _grid(n_points):
    return np.linspace(0.0 if n_points == 101 else 500.0, 100e3, n_points)


def _rel(got, want):
    return np.max(np.abs(np.asarray(got, np.float64) - want)) / \
        (np.max(np.abs(want)) + 1e-30)


def _torch(*xs, dtype=None):
    out = [torch.from_numpy(np.array(x)) for x in xs]
    return [t.to(dtype) if dtype is not None and t.is_floating_point() else t
            for t in out]


@pytest.mark.parametrize("backend", ["xla", "mxu"])
@pytest.mark.parametrize("n_points", [101, 100])
def test_project_matches_msgwam_tpu_f64(backend, n_points):
    rng = np.random.default_rng(11)
    grid = _grid(n_points)
    vals, r_low, r_up, pv, valid = _random_rays(rng, 400)
    span = jp.required_span(2500.0, grid[1] - grid[0])
    assert tp.required_span(2500.0, grid[1] - grid[0]) == span
    want = np.asarray(jp.project_backend(backend)(
        *(jnp.asarray(x) for x in (vals, r_low, r_up, pv, valid, grid)),
        max_span=span))
    got = tp.project_backend(backend)(*_torch(vals, r_low, r_up, pv, valid, grid),
                                      max_span=span)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("accum", ["native", "compensated", "f64"])
def test_project_dense_accum_modes_f64(accum):
    rng = np.random.default_rng(12)
    n = 8192 + 1000  # one full accumulation block and a remainder
    r = rng.uniform(1e3, 80e3, n)
    dr = rng.uniform(300.0, 3000.0, n)
    vals = rng.normal(0.0, 1.0, (2, n))
    pv = np.abs(rng.normal(1e-12, 1e-13, n))
    valid = rng.random(n) > 0.1
    grid = np.linspace(0.0, 100e3, 101)
    args = (vals, r - 0.5 * dr, r + 0.5 * dr, pv, valid, grid)
    want = np.asarray(jp.project_dense(*(jnp.asarray(x) for x in args),
                                       accum=accum))
    got = tp.project_dense(*_torch(*args), accum=accum)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-30)
    # and the scatter in float64 agrees with the dense form
    got_xla = tp.project(*_torch(*args), max_span=5, accum="f64")
    np.testing.assert_allclose(got_xla.numpy(), want, rtol=1e-12, atol=1e-30)


def test_projection_weights_and_spans_match():
    rng = np.random.default_rng(13)
    grid = _grid(101)
    _, r_low, r_up, _, valid = _random_rays(rng, 300)
    a = jp.projection_weights(jnp.asarray(r_low), jnp.asarray(r_up),
                              jnp.asarray(valid), jnp.asarray(grid), 5)
    b = tp.projection_weights(*_torch(r_low, r_up, valid, grid), 5)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("n_points", [101, 100])
def test_k1_twin_matches_project_pallas(n_points):
    """K1's plain twin in float32 against the Pallas kernel (interpret
    mode) and against the float64 oracle, at the bars of
    tests/test_projection.py."""
    rng = np.random.default_rng(14)
    grid = _grid(n_points)
    vals, r_low, r_up, pv, valid = _random_rays(rng, 400)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    want_pallas = np.asarray(jax_project_pallas(
        f32(vals), f32(r_low), f32(r_up), f32(pv), jnp.asarray(valid), f32(grid)))
    oracle = np.asarray(jp.project(
        *(jnp.asarray(x) for x in (vals, r_low, r_up, pv, valid, grid)),
        max_span=jp.required_span(2500.0, grid[1] - grid[0])))
    args = _torch(vals, r_low, r_up, pv, valid, grid, dtype=torch.float32)
    twin = projection_cuda.project_pallas_reference(*args)
    assert twin.dtype == torch.float32 and twin.shape == (2, n_points - 1)
    assert _rel(twin.numpy(), want_pallas.astype(np.float64)) <= 1e-5
    assert _rel(twin.numpy(), oracle) < 2e-5
    # the top cell never receives flux (reference quirk 4)
    assert np.all(twin.numpy()[:, -1] == 0.0)
    # on CPU tensors the wrapper is the twin, and launches nothing
    before = projection_cuda.LAUNCHES
    got = projection_cuda.project_pallas(*args)
    assert projection_cuda.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), twin.numpy())
    # one value row, no mask
    one = projection_cuda.project_pallas(args[0][0], *args[1:4], None, args[5])
    assert one.shape == (1, n_points - 1)


def test_k1_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(15)
    grid = _grid(101)
    vals, r_low, r_up, pv, valid = _random_rays(rng, 64)
    args = _torch(vals, r_low, r_up, pv, valid, grid, dtype=torch.float32)
    with pytest.raises(TypeError):
        projection_cuda.project_pallas(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        projection_cuda.project_pallas(torch.cat([args[0], args[0]]), *args[1:])
    with pytest.raises(ValueError):
        projection_cuda.project_pallas(*args, accum="f64")
    with pytest.raises(ValueError):
        projection_cuda.project_pallas(args[0], args[1][::2], *args[2:])


@pytest.mark.cuda
def test_k1_kernel_matches_twin_on_gpu(cuda_device):
    rng = np.random.default_rng(16)
    for n_points in (101, 100):
        grid = _grid(n_points)
        vals, r_low, r_up, pv, valid = _random_rays(rng, 100_000)
        args = [t.to(cuda_device) for t in _torch(
            vals, r_low, r_up, pv, valid, grid, dtype=torch.float32)]
        before = projection_cuda.LAUNCHES
        got = projection_cuda.project_pallas(*args)
        again = projection_cuda.project_pallas(*args)
        torch.cuda.synchronize()
        assert projection_cuda.LAUNCHES == before + 2
        twin = projection_cuda.project_pallas_reference(
            *[a.double() if a.is_floating_point() else a for a in args])
        assert _rel(got.cpu().numpy(), twin.cpu().numpy()) < 1e-6
        assert torch.equal(got, again)
