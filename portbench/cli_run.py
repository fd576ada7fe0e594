"""The ``cli_run`` kind of mix: each request is one in-process call of the
port's experiment driver, ``msgwam_tpu_torch.cli.main``, with the
arguments a user gives ``python -m msgwam_tpu_torch``::

    run --config <spec> --resume <checkpoint> --steps <steps_per_request>
        --log-every <save_every> --stream-history --no-plot --out <dir>

Set-up writes the spec and the checkpoint once, with the harness's own
code, from the configuration file and the seeded state that
:func:`.traffic.setup` made: the spec keeps the configuration's model
block, grid and dt and names the gaussian-spectrum source at the
configuration's ray count, with the mix's ``spec`` entries over them
(``traffic/cli_run.json``: float32, the whole-run kernel,
``"kernels": "mega"``, and ``projection_backend: "pallas"``, which on
that route picks only the diagnostics' deposit, K1); the checkpoint holds the seeded
rays and the initial wind at step 0 in the ``.npz`` layout that the
port's ``load_checkpoint`` reads, so the program sees only these inputs.

Every request writes into one output directory, which the next request
overwrites, as a user rerunning into the same ``--out`` does.  The
directory lives in memory (``/dev/shm``, or the system's temporary
directory where there is none), so that a request measures the program's
pack, copy and writer and not the machine's disk.  Its name is fixed for
one checkout and one temporary directory, so a run that was killed leaves
at most one such directory, which the next run there empties; set-up
refuses to start where the memory file system has no room for it.

The caller's host copy of each request is ``diagnostics.npz``'s winds,
read in the request's time.  Its check, outside that time: the size and
layout of the streamed history ``state_history.msgw`` (exactly one record
a frame, each record's winds those of the diagnostics) and
``final_state.npz``'s rays against the last record; a request whose files
fall short of that failed.  For a sampled request it also reads the
judged frames' rays and winds from the history and the diagnostics' wave
action and flux of those frames.  All of it is the harness's own code,
not the program's reader.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import tempfile
import weakref
import zipfile
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

MEMORY = Path("/dev/shm")
MAGIC = b"MSGW"
HEADER = struct.Struct("<4sIQ")
MANIFEST = "__msgwam_manifest__"
RAY_JUDGED = ("dens", "r", "m", "active")
# the evolving fields of the final checkpoint, and where it keeps them
FINAL = {"dens": "rays.dens", "r": "rays.r", "m": "rays.m",
         "active": "statics.active", "u": "mean.u", "v": "mean.v"}


def output_dir(need: int) -> Path:
    """This checkout's directory of the mix, in memory where the machine has
    a memory file system, emptied: its name is fixed by the checkout and
    the temporary directory, so each side of a comparison has its own and
    every run of a side the same.  Raises where the file system has fewer
    than ``need`` bytes free."""
    base = MEMORY if MEMORY.is_dir() and os.access(MEMORY, os.W_OK) else None
    base = base or Path(tempfile.gettempdir())
    key = f"{Path(__file__).resolve().parent}\0{Path(tempfile.gettempdir()).resolve()}"
    path = base / f"portbench-cli-{hashlib.sha256(key.encode()).hexdigest()[:16]}"
    shutil.rmtree(path, ignore_errors=True)
    free = shutil.disk_usage(base).free
    if free < need:
        raise RuntimeError(f"portbench: a cli_run mix needs {need} B free in "
                           f"{base}, and {free} B are")
    path.mkdir(parents=True)
    return path


def spec(conf: dict, traffic: dict) -> dict:
    """The experiment file of configuration ``conf`` under the mix
    ``traffic``: the configuration's model block, grid, dt and
    gaussian-spectrum source, the mix's run length and save cadence, and
    its ``spec`` entries over them (``model`` merged key by key)."""
    model = {k: v for k, v in conf["model"].items() if k != "dtype"}
    over = dict(traffic.get("spec", {}))
    model.update(over.pop("model", {}))
    return {
        "model": model,
        "grid": dict(conf["grid"]),
        "run": {"dt": float(conf["dt"]),
                "n_steps": int(traffic["steps_per_request"]),
                "save_every": int(traffic["save_every"])},
        "source": {"kind": "gaussian_spectrum", "n_ray": int(conf["n_ray"]),
                   **conf["spectrum"]},
        "background": "sine",
        **over,
    }


def write_checkpoint(path: Path, state, statics, step: int = 0) -> None:
    """The state and statics at ``step`` as a checkpoint: one array a
    field under ``rays.``, ``mean.`` and ``statics.``, and the manifest's
    JSON as bytes."""
    arrays = {}
    for prefix, tup in (("rays", state.rays), ("mean", state.mean),
                        ("statics", statics)):
        for name, x in zip(type(tup)._fields, tup):
            arrays[f"{prefix}.{name}"] = x.detach().cpu().numpy()
    text = json.dumps({"step": int(step), "version": 1, "extra": {}})
    arrays[MANIFEST] = np.frombuffer(text.encode(), dtype=np.uint8)
    np.savez(path, **arrays)


class History:
    """A streamed state history as the caller reads it: the 16-byte header
    (``MSGW``, version 1, the record's bytes), fixed-size records, and the
    ``.json`` sidecar with their layout.  ``frames`` is the number of
    whole records, ``whole`` whether the file holds nothing else."""

    def __init__(self, path: Path):
        self.path = path
        meta = json.loads(Path(f"{path}.json").read_text())
        layout = meta["state_layout"]
        self.dtype = np.dtype(meta["dtype"])
        self.capacity, self.n_cell = int(layout["capacity"]), int(layout["n_cell"])
        self.offsets = {}
        off = 0
        for name in layout["ray_fields"]:
            self.offsets[name] = (off, self.capacity)
            off += self.capacity
        for name in layout["mean_fields"]:
            self.offsets[name] = (off, self.n_cell)
            off += self.n_cell
        self.record_bytes = off * self.dtype.itemsize
        with open(path, "rb") as f:
            magic, version, record_bytes = HEADER.unpack(f.read(HEADER.size))
        size = path.stat().st_size - HEADER.size
        self.frames = size // self.record_bytes
        self.whole = (magic == MAGIC and version == 1
                      and record_bytes == self.record_bytes
                      and [off] == list(meta["record_shape"])
                      and size == self.frames * self.record_bytes)

    def field(self, frame: int, name: str) -> np.ndarray:
        """One field of one record (``active`` as bool)."""
        off, count = self.offsets[name]
        x = np.fromfile(self.path, dtype=self.dtype, count=count,
                        offset=HEADER.size + frame * self.record_bytes
                        + off * self.dtype.itemsize)
        return x != 0 if name == "active" else x


class ReadBack(NamedTuple):
    failed: bool            # the files fall short
    rays: dict              # {frame: (dens, r, m, active)} of the judged frames
    wind: dict              # {frame: (u, v)} from the history
    diag: dict              # {frame: (wave_action, flux)} from the diagnostics


SHORT = ReadBack(True, {}, {}, {})


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    """Whether ``got`` holds ``want``'s values bit for bit, in its dtype."""
    got = got.astype(want.dtype, copy=False)
    return got.shape == want.shape and np.array_equal(
        got.view(np.uint8), want.view(np.uint8))


class CliRun:
    """The requests of one ``cli_run`` mix on one configuration: the
    inputs written once, the argument list, and the read-back."""

    def __init__(self, s, traffic: dict):
        steps, save_every = int(traffic["steps_per_request"]), int(traffic["save_every"])
        self.frames = steps // save_every
        self.n_ray = int(s.state0.rays.r.numel())
        self.n_cell = int(s.bg.centers.shape[0])
        # the history and the two checkpoints of 14 fields, twice over
        self.dir = output_dir(2 * 4 * self.n_ray * (11 * self.frames + 28))
        self._cleanup = weakref.finalize(self, shutil.rmtree, self.dir, True)
        self.out = self.dir / "out"
        spec_path, ckpt = self.dir / "spec.json", self.dir / "seeded.npz"
        self.spec = spec(s.conf, traffic)
        spec_path.write_text(json.dumps(self.spec))
        write_checkpoint(ckpt, s.state0, s.statics0)
        self.argv = ["run", "--config", str(spec_path), "--resume", str(ckpt),
                     "--steps", str(steps), "--log-every", str(save_every),
                     "--stream-history", "--no-plot", "--out", str(self.out)]
        if s.state0.rays.r.device.type != "cuda":
            self.argv += ["--device", str(s.state0.rays.r.device)]

    def close(self) -> None:
        """Remove the inputs and the output directory."""
        self._cleanup()

    def request(self) -> None:
        """One run of the experiment driver, in this process."""
        from msgwam_tpu_torch import cli

        cli.main(list(self.argv))

    def history(self) -> History:
        return History(self.out / "state_history.msgw")

    def host_copy(self) -> torch.Tensor:
        """The caller's host copy of the last request: ``diagnostics.npz``'s
        u and v, ``(2, frames, n_cell)``; NaN where the file is missing,
        malformed or of another shape."""
        shape = (self.frames, self.n_cell)
        try:
            with np.load(self.out / "diagnostics.npz") as z:
                u, v = z["u"], z["v"]
            if u.shape == v.shape == shape:
                return torch.from_numpy(np.stack([u, v]))
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            pass
        return torch.full((2, *shape), float("nan"))

    def read_back(self, host: torch.Tensor, judged=()) -> ReadBack:
        """The check of the last request, whose host copy is ``host``:
        ``judged`` are the frames whose rays, winds and diagnostics the
        check needs.  Files that are missing, malformed or short, or that
        disagree with each other, fail the request."""
        try:
            h = self.history()
            u, v = host.numpy()
            if not (h.whole and h.frames == self.frames
                    and h.capacity == self.n_ray and h.n_cell == self.n_cell
                    and self._final_is_last(h)
                    and all(_same(h.field(f, "u"), u[f])
                            and _same(h.field(f, "v"), v[f])
                            for f in range(self.frames))):
                return SHORT
            diag = {}
            if judged:
                with np.load(self.out / "diagnostics.npz") as z:
                    diag = {f: (_tensor(z["wave_action"][f]), _tensor(z["flux"][f]))
                            for f in judged}
        except (OSError, ValueError, KeyError, IndexError, zipfile.BadZipFile):
            return SHORT
        rays, wind = {}, {}
        for g in sorted({g for f in judged for g in (f - 1, f) if g >= 0}):
            rays[g] = tuple(_tensor(h.field(g, n)) for n in RAY_JUDGED)
            wind[g] = (_tensor(h.field(g, "u")), _tensor(h.field(g, "v")))
        return ReadBack(False, rays, wind, diag)

    def _final_is_last(self, h: History) -> bool:
        """Whether ``final_state.npz`` holds the last record's evolving
        ray fields, their activity and the winds, bit for bit (the frozen
        fields are read by no judged number)."""
        with np.load(self.out / "final_state.npz") as z:
            return all(_same(z[key], h.field(self.frames - 1, name))
                       for name, key in FINAL.items())

    def covered_frames(self) -> list:
        """``(r, active)`` of every frame of the last request's history."""
        h = self.history()
        return [(_tensor(h.field(f, "r")), _tensor(h.field(f, "active")))
                for f in range(min(h.frames, self.frames))]
