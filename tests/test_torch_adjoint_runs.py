"""Gradients through the whole-run kernels K5 (``simulate_resident``) and
K7 (``simulate_streaming_ensemble``) in float32, their twins running on
CPU tensors, against the JAX package's gradients through its Pallas
kernels in interpret mode and against the port's plain route, at the bar
of tests/test_megakernel.py (rtol 5e-4)."""

import jax.numpy as jnp
import numpy as np
import torch

import msgwam_tpu as mt
import msgwam_tpu_torch as mtt
from msgwam_tpu.models.backgrounds import tidal_shear as jax_tidal_shear
from msgwam_tpu.ops.step_pallas import simulate_resident as jax_resident
from msgwam_tpu.ops.step_pallas_stream import (
    simulate_streaming_ensemble as jax_ensemble)
from msgwam_tpu.parallel import stack_ensemble as jax_stack
from msgwam_tpu_torch.parallel import stack_ensemble
from msgwam_tpu_torch.state import tree_map
from test_torch_adjoint_kernels import (assert_grads_close, jax_grads, setup_f32,
                                        tcfg, torch_grads)

torch.set_num_threads(1)


def test_k5_gradient_matches_msgwam_tpu():
    """3 steps of 300 rays padded to 512 through ``simulate_resident``:
    its backward differentiates ``simulate`` on the plain path."""
    cfg, bg, state, statics = setup_f32(300, 512)
    run = mt.RunConfig(dt=120.0, n_steps=3, save_every=3)
    want = jax_grads(lambda s: jax_resident(s, statics, bg, cfg, run)[0],
                     state, 512)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    trun = mtt.RunConfig(dt=120.0, n_steps=3, save_every=3)
    got = torch_grads(lambda s_: mtt.simulate_resident(s_, st, b, tcfg(cfg),
                                                       trun)[0], s, 512)
    plain = torch_grads(lambda s_: mtt.simulate(
        s_, st, b, tcfg(cfg.replace(window_cells=0)), trun,
        validate=False)[0], s, 512)
    assert_grads_close(got, want)
    assert_grads_close(got, plain)


def test_k7_gradient_matches_msgwam_tpu():
    """Two members of 300 rays padded to 512, 3 steps, each with its own
    prescribed tide (the wind is not prognostic, so the loss reads the
    final density): the backward runs ``simulate`` member by member with
    that member's ``wind_fn``."""
    cfg, bg, state, statics = setup_f32(300, 512, prognostic_mean=False)
    run = mt.RunConfig(dt=120.0, n_steps=3, save_every=3)
    cj = jnp.asarray(mt.GridConfig().centers(), jnp.float32)
    jwinds = [lambda t, a=a: (a * jax_tidal_shear(cj, t, cfg), jnp.zeros_like(cj))
              for a in (1.0, 2.0)]
    ct = torch.tensor(np.asarray(cj))
    twinds = [lambda t, a=a: (a * mtt.tidal_shear(ct, t, tcfg(cfg)),
                              torch.zeros_like(ct)) for a in (1.0, 2.0)]
    scale = float(np.max(np.asarray(state.rays.dens)))

    def density(final, _):
        return final.rays.dens / scale

    bstates, bstatics = jax_stack([(state, statics)] * 2)
    want = jax_grads(lambda s: jax_ensemble(s, bstatics, bg, cfg, run,
                                            wind_fn=jwinds)[0],
                     bstates, (2, 512), density)
    s, st, b = mtt.from_numpy((state, statics, bg), device="cpu")
    ts, tst = stack_ensemble([(s, st)] * 2)
    trun = mtt.RunConfig(dt=120.0, n_steps=3, save_every=3)
    got = torch_grads(lambda s_: mtt.simulate_streaming_ensemble(
        s_, tst, b, tcfg(cfg), trun, wind_fn=twinds)[0], ts, (2, 512), density)

    def plain_run(s_):
        member = lambda tree, e: tree_map(lambda x: x[e], tree)
        finals = [mtt.simulate(member(s_, e), member(tst, e), b,
                               tcfg(cfg.replace(window_cells=0)), trun,
                               wind_fn=twinds[e], validate=False)[0]
                  for e in range(2)]
        return tree_map(lambda *xs: torch.stack(xs), *finals)

    plain = torch_grads(plain_run, ts, (2, 512), density)
    assert_grads_close(got, want)
    assert_grads_close(got, plain)
