"""The binding of the port's CUDA kernels, checked without a compiler: the
``ctypes`` signatures in ``msgwam_tpu_torch/_build.py`` against the
``extern "C"`` declarations of ``msgwam_tpu_torch/csrc/*.cu`` (a pointer
passed where ctypes expects an int is cut to 32 bits without a word), and
the guard that the entry points without a backward (K1, K6) raise instead
of returning a result without a gradient."""

import ctypes
import re

import pytest
import torch

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch import _build
from msgwam_tpu_torch.ops import (projection_cuda, rhs_cuda, rhs_cuda_windowed,
                                  step_cuda_stream)
from msgwam_tpu_torch.parallel import stack_ensemble

KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
KERNEL_ENTRIES = {"msgwam_project_plan", "msgwam_project", "msgwam_rhs_plan",
                  "msgwam_rhs_fused", "msgwam_rhs_windowed",
                  "msgwam_step_resident_plan", "msgwam_step_resident"}


def _declarations():
    decls = {}
    for src in sorted(_build.SRC_DIR.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, args in re.findall(r'extern "C" int (msgwam_\w+)\(([^)]*)\)',
                                     text):
            kinds = []
            for arg in (a.strip() for a in args.split(",")):
                if "*" in arg:
                    kinds.append("pointer")
                elif re.match(r"(const\s+)?int\b", arg):
                    kinds.append("int")
                elif re.match(r"(const\s+)?float\b", arg):
                    kinds.append("float")
                else:
                    raise AssertionError(f"{src.name}: {name}: cannot bind {arg!r}")
            decls[name] = kinds
    return decls


def test_ctypes_signatures_match_the_sources():
    decls = _declarations()
    assert set(decls) == set(_build.SIGNATURES) == KERNEL_ENTRIES
    for name, kinds in decls.items():
        bound = [KINDS[t] for t in _build.SIGNATURES[name]]
        assert bound == kinds, name


def _bench_inputs(n=300):
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(saturate_online=True,
                                           dtype="float32", rhs_backend="pallas")
    gc = mtt.GridConfig()
    uu = mtt.velocities_sine_homogeneous(
        torch.tensor(gc.centers(), dtype=torch.float32), cfg)
    bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu),
                             dtype=torch.float32, device="cpu")
    rays, statics = mtt.gaussian_spectrum_source(cfg, bg, n, dtype=torch.float32)
    state = mtt.State(rays, mtt.MeanState(uu, torch.zeros_like(uu)))
    return cfg, bg, state, statics


def _with_grad(state):
    dens = state.rays.dens.clone().requires_grad_(True)
    return state._replace(rays=state.rays._replace(dens=dens))


ENTRY_POINTS = {
    "project_pallas": lambda cfg, bg, s, st: projection_cuda.project_pallas(
        torch.stack([s.rays.dens, s.rays.dens]), s.rays.r - 0.5 * s.rays.dr,
        s.rays.r + 0.5 * s.rays.dr, torch.abs(st.dkk * st.dll * s.rays.dm),
        st.active, bg.centers),
    "rhs_fused": lambda cfg, bg, s, st: rhs_cuda.rhs_fused(
        120.0, s, st, bg, cfg.replace(window_cells=0)),
    "rhs_fused_windowed": lambda cfg, bg, s, st:
        rhs_cuda_windowed.rhs_fused_windowed(120.0, s, st, bg, cfg),
    "rk3_step_fused_windowed": lambda cfg, bg, s, st:
        rhs_cuda_windowed.rk3_step_fused_windowed(120.0, s, st, bg, cfg),
    "simulate_resident": lambda cfg, bg, s, st: mtt.simulate_resident(
        s, st, bg, cfg, mtt.RunConfig(dt=120.0, n_steps=1, save_every=1)),
    "simulate_streaming": lambda cfg, bg, s, st: step_cuda_stream.simulate_streaming(
        s, st, bg, cfg.replace(cull=True, relaunch=True),
        mtt.RunConfig(dt=120.0, n_steps=1, save_every=1), source=(s.rays, st)),
    "simulate_streaming_ensemble": lambda cfg, bg, s, st:
        mtt.simulate_streaming_ensemble(
            *stack_ensemble([(s, st)] * 2), bg, cfg,
            mtt.RunConfig(dt=120.0, n_steps=1, save_every=1)),
}


FORWARD_ONLY = {"project_pallas", "simulate_streaming"}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_kernel_entry_points_refuse_gradients(entry):
    """With grad mode on and an input that needs a gradient, the entry
    points without a backward, K1 and K6, raise and name the
    differentiable route, on the CPU as on the card, as in the JAX
    package; K2-K5 and K7 record their backward instead.  Under
    ``torch.no_grad()`` each runs."""
    cfg, bg, state, statics = _bench_inputs()
    call = ENTRY_POINTS[entry]
    if entry in FORWARD_ONLY:
        with pytest.raises(NotImplementedError,
                           match="forward only, as in the JAX package"):
            call(cfg, bg, _with_grad(state), statics)
    else:
        out = call(cfg, bg, _with_grad(state), statics)
        assert any(t.grad_fn is not None for t in _build._tensors(out))
    with torch.no_grad():
        out = call(cfg, bg, _with_grad(state), statics)
    # nothing needs a gradient: it runs with grad mode on, too
    again = call(cfg, bg, state, statics)
    for a, b in zip(_build._tensors(out), _build._tensors(again)):
        assert torch.equal(a, b) and bool(torch.isfinite(a.float()).all())
