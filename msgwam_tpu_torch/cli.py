"""Experiment driver CLI of the port: the counterpart of
:mod:`msgwam_tpu.cli` (the reference's L3 layer, ``raytracer.py``), with
the same presets, config files and flags.

Usage:
    python -m msgwam_tpu_torch run --config experiment.json --out results/
    python -m msgwam_tpu_torch run --preset reference --steps 200 --out results/
    python -m msgwam_tpu_torch run --preset fast --kernels mega --no-plot

The run goes to the card unless ``--device`` names another device
(``--device cpu`` runs the plain PyTorch paths and the kernels' twins on
the CPU); without a card and without ``--device`` it fails at once.

``--kernels`` names the port's routes: ``xla`` and ``mxu`` are the plain
PyTorch paths, ``pallas`` the fused RHS kernel K2, ``windowed`` the
stage-fused kernel K4 and ``mega`` the whole-run kernel K5, which a run
with the lifecycle or a transient background takes to K6.  A config's
``projection_backend: "pallas"`` deposits with K1 (the diagnostics always,
the step on ``rhs_backend: "xla"``), and ``integrator: "rk4"`` with the
windowed kernel runs K3.  The CUDA kernels compute in float32: a float64
run takes ``--kernels xla`` or ``mxu``.

The JSON config mirrors the driver constants block (``raytracer.py:32-64``)
plus any :class:`~msgwam_tpu_torch.config.ModelConfig` field, e.g.::

    {
      "model": {"u0": 4.0, "kappa": 1.0, "saturate_online": false,
                "hprop": false, "phi0": 0.0, "rr0": 40000.0},
      "grid": {"n_face": 101, "z_max": 100e3},
      "run": {"dt": 120.0, "n_steps": 1440, "save_every": 10},
      "source": {"kind": "wave_packet", "n_ray": 60, "alpha": 0.01},
      "background": "sine",
      "dtype": "float64"
    }

``--shard`` splits the rays over the ranks of a ``torch.distributed``
world, one process per rank, with one all-reduce of the flux per RHS
evaluation (:mod:`msgwam_tpu_torch.parallel.sharding`): run it under
``torchrun`` (``torchrun --nproc_per_node 2 -m msgwam_tpu_torch run
--shard --device cpu ...`` on the CPU, gloo; one rank per card on GPUs,
NCCL), or alone as a world of 1.  Every rank gathers the history and the
final state; rank 0 alone writes the files and the plot.

``bench`` runs the port's benchmark (:mod:`msgwam_tpu_torch.bench`, the
counterpart of the JAX package's ``bench.py``); every flag after it is
forwarded there, ``--help`` included::

    python -m msgwam_tpu_torch bench                      # 1e5 x 8000 on K5, 1e6 extra
    python -m msgwam_tpu_torch bench --all --steps 72     # one row per backend
    python -m msgwam_tpu_torch bench --matrix --out results/   # results/bench_matrix.json
    python -m msgwam_tpu_torch bench --n-ray 512 --steps 5 --backend mxu --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from . import models as _models
from .config import GridConfig, ModelConfig, RunConfig
from .diagnostics import WaveActionDiagnostics, wave_action_history
from .models import gaussian_spectrum_source, simulate, wave_packet_ic
from .ops.projection import required_span
from .ops.step_cuda import simulate_resident
from .state import MeanState, State, default_device, make_background, tree_map
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.metrics import MetricsLogger

REFERENCE_PRESET = {
    "model": {
        "bvf": 0.01, "boussinesq": False, "sig_rr": 10000.0, "u0": 4.0,
        "rr0": 40000.0, "rr1": 40000.0, "phi0": 0.0, "kappa": 1.0,
        "saturate_online": False, "hprop": False,
    },
    "grid": {"n_face": 101, "z_max": 100e3},
    "run": {"dt": 120.0, "n_steps": 1440, "save_every": 1},
    "source": {"kind": "wave_packet", "n_ray": 60, "alpha": 0.01},
    "background": "sine",
    "dtype": "float64",
}

FAST_PRESET = {
    "model": {
        "bvf": 0.01, "u0": 4.0, "rr0": 40000.0, "phi0": 0.0, "kappa": 1.0,
        "saturate_online": True, "hprop": False,
        "projection_backend": "mxu", "interp_backend": "mxu",
        # Kahan-combined block partials of the float32 dense deposit
        "flux_accum": "compensated",
    },
    "grid": {"n_face": 101, "z_max": 100e3},
    "run": {"dt": 120.0, "n_steps": 720, "save_every": 10},
    "source": {"kind": "gaussian_spectrum", "n_ray": 100000,
               "z_launch": 2000.0, "dz_launch": 500.0,
               "amplitude_alpha": 0.001},
    "background": "sine",
    "dtype": "float32",
}

PRESETS = {"reference": REFERENCE_PRESET, "fast": FAST_PRESET}

BACKGROUNDS = {
    "sine": "velocities_sine_homogeneous",
    "tanh": "velocities_tanh_homogeneous",
    "gauss": "velocities_gauss_homogeneous",
    "zero": None,
}

# Named transient backgrounds: a JSON config cannot carry a wind_fn
# callable, so ``"background": {"kind": "tidal", ...}`` names one from this
# registry; the other keys are keyword arguments of the factory
# (models/backgrounds.py), f(centers, t, cfg, **params) -> u(z, t); v is
# zero.  examples/config4.json runs one.
TRANSIENT_BACKGROUNDS = {
    "tidal": "tidal_shear",
}

# --kernels routes whose kernels compute in float32 only
KERNEL_ROUTES = ("pallas", "windowed", "mega")


def _load_config(args) -> dict:
    if args.config:
        with open(args.config) as f:
            spec = json.load(f)
    else:
        spec = json.loads(json.dumps(PRESETS[args.preset]))  # deep copy
    if args.steps:
        spec["run"]["n_steps"] = args.steps
        # keep save_every a divisor of the overridden n_steps (simulate
        # requires divisibility): largest divisor <= the preset's cadence
        cap = min(spec["run"].get("save_every", 1), args.steps)
        while args.steps % cap:
            cap -= 1
        spec["run"]["save_every"] = cap
    # --kernels from the command line, else "kernels" from the config
    # file: both install the matching model-backend settings.  A
    # command-line choice overrides the preset/file model block; a
    # file-level "kernels" only fills backends the file left unset.
    from_args = getattr(args, "kernels", None)
    kernels = from_args or spec.get("kernels")
    if kernels:
        model = spec.setdefault("model", {})
        if kernels == "xla":
            override = dict(projection_backend="xla",
                            interp_backend="gather",
                            rhs_backend="xla", window_cells=0)
        elif kernels == "mxu":
            override = dict(projection_backend="mxu", interp_backend="mxu",
                            rhs_backend="xla", window_cells=0)
        elif kernels == "pallas":
            override = dict(projection_backend="mxu", interp_backend="mxu",
                            rhs_backend="pallas", window_cells=0)
        elif kernels in ("windowed", "mega"):
            # the window widths stay the ModelConfig auto sentinels (-1),
            # resolved by the kernels' drivers; a config-file
            # window_cells/window_cells2 stays explicit and wins
            override = dict(projection_backend="mxu", interp_backend="mxu",
                            rhs_backend="pallas")
        else:
            raise ValueError(f"unknown kernels choice {kernels!r}")
        if from_args:
            model.update(override)
        else:
            for key, val in override.items():
                model.setdefault(key, val)
        spec["kernels"] = kernels
    w2 = getattr(args, "window2", None)
    if w2 is not None:
        spec.setdefault("model", {})["window_cells2"] = w2
    return spec


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_experiment(
    spec: dict,
    out_dir: str,
    make_plot: bool = True,
    log_every: int = 0,
    resume_from: str = None,
    stream_history: bool = False,
    shard: bool = False,
    device=None,
) -> dict:
    """Run the experiment ``spec`` (a :func:`_load_config` dict) and write
    ``final_state.npz`` (a checkpoint), ``diagnostics.npz`` and, with
    ``make_plot``, ``wave_action.png`` into ``out_dir``.  ``device`` is the
    card unless another device is given
    (:func:`msgwam_tpu_torch.state.default_device`).

    ``shard`` splits the rays over the ranks of the ``torch.distributed``
    world (set up here from ``torchrun``'s environment, or as a world of 1,
    where no process group exists, and taken down at the end), each rank
    on ``device`` or ``cuda:LOCAL_RANK``; ranks other than 0 write nothing
    and return ``None`` for the checkpoint."""
    if not shard:
        return _run_experiment(spec, out_dir, make_plot, log_every,
                               resume_from, stream_history, False,
                               default_device(device))
    from .parallel.distributed import world

    with world(device=device) as device:
        return _run_experiment(spec, out_dir, make_plot, log_every,
                               resume_from, stream_history, True, device)


def _run_experiment(spec, out_dir, make_plot, log_every, resume_from,
                    stream_history, shard, device) -> dict:
    writes = not shard or dist.get_rank() == 0
    say = print if writes else (lambda *a: None)
    dtype_name = "float64" if spec.get("dtype") == "float64" else "float32"
    dtype = getattr(torch, dtype_name)
    cfg = ModelConfig(dtype=dtype_name, **spec.get("model", {}))
    gc = GridConfig(**spec.get("grid", {}))
    run = RunConfig(**spec.get("run", {}))
    if dtype_name == "float64" and (
            spec.get("kernels") in KERNEL_ROUTES or cfg.rhs_backend == "pallas"
            or cfg.projection_backend == "pallas"):
        raise ValueError(
            "the CUDA kernels compute in float32, and this spec is float64 "
            "with a kernel route (--kernels "
            f"{spec.get('kernels') or 'from the model block'}); run float64 "
            "with --kernels xla|mxu, or set \"dtype\": \"float32\"")

    with torch.no_grad():
        centers = torch.as_tensor(gc.centers(), dtype=dtype, device=device)
        bg_spec = spec.get("background", "sine")
        wind_fn = None
        if isinstance(bg_spec, dict):
            kind = bg_spec.get("kind")
            if kind not in TRANSIENT_BACKGROUNDS:
                raise ValueError(
                    f"unknown transient background kind {kind!r}; "
                    f"known: {sorted(TRANSIENT_BACKGROUNDS)}")
            params = {k: v for k, v in bg_spec.items() if k != "kind"}
            fn = getattr(_models, TRANSIENT_BACKGROUNDS[kind])
            zeros = torch.zeros_like(centers)
            wind_fn = lambda t: (fn(centers, t, cfg, **params).to(dtype),
                                 zeros)
            uu = wind_fn(0.0)[0]  # hydrostatics/pressure gradient use t=0
        else:
            bg_name = BACKGROUNDS[bg_spec]
            if bg_name is None:
                uu = torch.zeros_like(centers)
            else:
                uu = getattr(_models, bg_name)(centers, cfg).to(dtype)
        vv = torch.zeros_like(uu)
        bg = make_background(gc, cfg, uu, vv, dtype=dtype, device=device)

        src = dict(spec.get("source", {"kind": "wave_packet"}))
        kind = src.pop("kind", "wave_packet")
        if kind == "wave_packet":
            rays, statics = wave_packet_ic(gc, cfg, bg, dtype=dtype,
                                           device=device, **src)
        elif kind == "gaussian_spectrum":
            n_ray = src.pop("n_ray")
            rays, statics = gaussian_spectrum_source(cfg, bg, n_ray,
                                                     dtype=dtype, **src)
        else:
            raise ValueError(f"unknown source kind {kind!r}")
        state = State(rays, MeanState(uu, vv))
        source = (rays, statics) if cfg.relaunch else None

        # d(dr)/dt is structurally zero in this model, so the widest ray
        # volume is known at run start: raise max_span so the xla scatter
        # never truncates a deposit
        if cfg.projection_backend == "xla":
            need = required_span(float(rays.dr.max()), gc.dz)
            if need > cfg.max_span:
                say(f"raising max_span {cfg.max_span} -> {need} "
                    f"(widest ray volume spans {need} cells)")
                cfg = cfg.replace(max_span=need)

        step0 = 0
        if resume_from:
            state, statics, step0, _, _ = load_checkpoint(resume_from,
                                                          device=device)
            say(f"resumed from {resume_from} at step {step0}")
        # resumed runs continue physical time where the checkpoint stopped:
        # transient backgrounds and the output time axis both use t0
        t0 = step0 * run.dt

        # --kernels mega: the whole-run kernel K5 (K6 with the lifecycle or
        # a transient background) where the run is in its scope; otherwise
        # the stage-fused kernel K4 that _load_config configured, with the
        # reason printed
        use_mega = False
        if spec.get("kernels") == "mega":
            reasons = []
            if cfg.hprop:
                reasons.append("hprop=True")
            if (cfg.cull or cfg.relaunch) and not cfg.saturate_online:
                # the in-kernel lifecycle runs only with online saturation
                reasons.append("culling/relaunch with offline saturation")
            if shard:
                # ray sharding runs the scan path, as in the JAX package
                # (the whole-run kernels shard over ensemble members)
                reasons.append("--shard uses the scan path")
            if reasons:
                say("--kernels mega: falling back to the adaptive-window "
                    "kernel (" + "; ".join(reasons) + ")")
            else:
                use_mega = True

        # every run takes its chunk's physical start time: with
        # --log-every the run is host-chunked, and a transient background
        # continues its phase across chunks
        if use_mega:
            def sim(s, st, r, toff):
                return simulate_resident(s, st, bg, cfg, r, source=source,
                                         wind_fn=wind_fn, t0=toff)
        elif shard:
            sim = _sharded_sim(state, bg, cfg, source, wind_fn, say)
        else:
            def sim(s, st, r, toff):
                return simulate(s, st, bg, cfg, r, source=source,
                                wind_fn=wind_fn, t0=toff)

        if log_every:
            # host-chunked stepping with structured progress metrics
            logging.basicConfig(level=logging.INFO, format="%(message)s")
            chunk = RunConfig(dt=run.dt, n_steps=log_every,
                              save_every=run.save_every)
            if log_every % run.save_every or run.n_steps % log_every:
                raise ValueError("log_every must tile save_every and n_steps")
            logger = MetricsLogger(run.n_steps, every=log_every)
            pieces = []       # the device history chunks (non-streamed mode)
            diag_pieces = []  # per-chunk diagnostics (streamed mode: small)
            uv_frames = []    # (frames, n_cell) wind profiles (streamed mode)
            with contextlib.ExitStack() as stack:
                writer = None
                if stream_history and writes:
                    from .utils.history_io import StateHistoryWriter

                    os.makedirs(out_dir, exist_ok=True)
                    writer = stack.enter_context(StateHistoryWriter(
                        os.path.join(out_dir, "state_history.msgw"),
                        capacity=int(state.rays.dens.shape[0]),
                        n_cell=gc.n_cell, dtype=np.dtype(dtype_name)))
                for start in range(0, run.n_steps, log_every):
                    state, statics, h = sim(state, statics, chunk,
                                            t0 + start * run.dt)
                    _sync(device)
                    if writes:
                        logger.record(
                            start + log_every,
                            max_u=float(state.mean.u.abs().max()),
                            active=float(statics.active.sum()),
                        )
                    if stream_history:
                        # streamed mode: every decimated frame goes to disk
                        # through the async writer, one host copy a frame,
                        # and only the per-frame grid diagnostics stay
                        h_state, h_active, h_prop = h
                        for fi in range(h_active.shape[0]):
                            if writer is not None:
                                writer.push_frame(
                                    tree_map(lambda x: x[fi], h_state.rays),
                                    h_active[fi], h_prop[fi],
                                    tree_map(lambda x: x[fi], h_state.mean))
                        diag_pieces.append(wave_action_history(
                            h_state.rays, h_active, statics, bg, cfg))
                        uv_frames.append((h_state.mean.u.cpu().numpy(),
                                          h_state.mean.v.cpu().numpy()))
                    else:
                        pieces.append(h)
            if stream_history:
                diag = WaveActionDiagnostics(
                    *(torch.cat(xs) for xs in zip(*diag_pieces)))
                hist_u = np.concatenate([u for u, _ in uv_frames])
                hist_v = np.concatenate([v for _, v in uv_frames])
                hist = None
            else:
                hist = tree_map(lambda *xs: torch.cat(xs), *pieces)
            final, statics_f = state, statics
        else:
            final, statics_f, hist = sim(state, statics, run, t0)
        if not writes:
            return {"checkpoint": None, "figure": None, "out_dir": out_dir}

        os.makedirs(out_dir, exist_ok=True)
        ckpt = os.path.join(out_dir, "final_state.npz")
        save_checkpoint(ckpt, final, statics_f, step=step0 + run.n_steps,
                        extra={"spec": spec})

        if hist is not None:
            hist_state, hist_active, _ = hist
            diag = wave_action_history(
                hist_state.rays, hist_active, statics_f, bg, cfg)
            hist_u = hist_state.mean.u.cpu().numpy()
            hist_v = hist_state.mean.v.cpu().numpy()
        time = t0 + np.arange(1, run.n_steps // run.save_every + 1) \
            * run.dt * run.save_every
        wave_action = diag.wave_action.cpu().numpy()
        tendency = diag.tendency.cpu().numpy()
        np.savez(
            os.path.join(out_dir, "diagnostics.npz"),
            wave_action=wave_action,
            flux=diag.flux.cpu().numpy(),
            tendency=tendency,
            u=hist_u,
            v=hist_v,
            time=time,
        )
    fig_path = None
    if make_plot:
        from .plotting import plot_wave_action_panels

        fig_path = os.path.join(out_dir, "wave_action.png")
        faces = bg.faces.cpu().numpy()
        plot_wave_action_panels(
            time, faces[:-1] + 0.5 * (faces[1] - faces[0]), wave_action,
            tendency, plot_max_s=float(time[-1]), show=False,
            save_path=fig_path,
        )
    return {"checkpoint": ckpt, "figure": fig_path, "out_dir": out_dir}


def _sharded_sim(state, bg, cfg, source, wind_fn, say):
    """The ``--shard`` runner ``sim(state, statics, run, t0)``: the rays
    split over the world's ranks, every output gathered to every rank."""
    from .parallel import (full_history_observe, full_history_observe_spec,
                           gather_state, make_mesh, sharded_simulate)

    if wind_fn is not None:
        raise ValueError(
            "--shard does not support transient backgrounds (the sharded "
            "scan path has no wind_fn threading); drop --shard or use a "
            "static background")
    mesh = make_mesh()
    n_ranks = dist.get_world_size()
    n_cap = int(state.rays.dens.shape[0])
    if n_cap % n_ranks:
        raise ValueError(
            f"--shard: ray count {n_cap} must be divisible by the world "
            f"size {n_ranks} (source n_ray controls it)")
    say(f"--shard: rays split over {n_ranks} rank(s)")
    spec = full_history_observe_spec()

    def sim(s, st, r, toff):  # toff unused: transient winds are refused
        f, sf, h = sharded_simulate(mesh, s, st, bg, cfg, r,
                                    observe=full_history_observe,
                                    observe_spec=spec, source=source)
        return (gather_state(mesh, f), gather_state(mesh, sf),
                gather_state(mesh, h, spec))

    return sim


def main(argv=None):
    ap = argparse.ArgumentParser(prog="msgwam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run an experiment")
    runp.add_argument("--config", help="JSON experiment config")
    runp.add_argument("--preset", choices=sorted(PRESETS), default="reference")
    runp.add_argument("--steps", type=int, help="override n_steps")
    runp.add_argument("--out", default="results")
    runp.add_argument("--no-plot", action="store_true")
    runp.add_argument("--log-every", type=int, default=0,
                      help="emit structured progress metrics every N steps")
    runp.add_argument("--resume", help="checkpoint (.npz) to resume from")
    runp.add_argument("--stream-history", action="store_true",
                      help="stream every saved frame to disk through the "
                           "native async writer (requires --log-every)")
    runp.add_argument("--shard", action="store_true",
                      help="split the rays over the ranks of the "
                           "torch.distributed world (torchrun, or a world "
                           "of 1): one all-reduce of the flux per RHS "
                           "evaluation; rank 0 writes the results")
    runp.add_argument("--window2", type=int,
                      help="second window tier (window_cells2) for the "
                           "windowed/mega kernels; 0 disables")
    runp.add_argument("--kernels",
                      choices=["xla", "mxu", "pallas", "windowed", "mega"],
                      help="compute route: xla = parity backends (scatter "
                           "deposit, np.interp-exact lookups); mxu = dense "
                           "torch backends; pallas = the fused-RHS CUDA "
                           "kernel K2; windowed = the stage-fused windowed "
                           "kernel K4; mega = the whole-run kernel K5 (K6 "
                           "with the lifecycle or a transient background; "
                           "K4 for hprop or lifecycle with offline "
                           "saturation).  The kernels are float32 only")
    runp.add_argument("--device",
                      help="torch device to run on (default: the card; "
                           "'cpu' runs the plain paths and the kernels' "
                           "twins)")
    # add_help=False: ``bench --help`` shows the bench's own flags, so
    # --help rides along in the forwarded extras
    sub.add_parser(
        "bench", add_help=False,
        help="run the benchmark; every flag is forwarded to "
             "msgwam_tpu_torch.bench (--backend/--n-ray/--steps/--matrix/"
             "--device/--help/...)")
    args, extra = ap.parse_known_args(argv)
    if args.cmd == "bench":
        from . import bench

        bench.cli(extra)
        return
    if extra:
        # error against the run subparser so the message carries its usage
        runp.error(f"unrecognized arguments: {' '.join(extra)}")

    spec = _load_config(args)
    result = run_experiment(
        spec, args.out, make_plot=not args.no_plot,
        log_every=args.log_every, resume_from=args.resume,
        stream_history=args.stream_history, shard=args.shard,
        device=args.device,
    )
    if result["checkpoint"] is not None:
        print(json.dumps(result))


if __name__ == "__main__":
    main()
