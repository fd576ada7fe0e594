"""Checkpoint / resume for the simulation state: the counterpart of
:mod:`msgwam_tpu.utils.checkpoint`, in the same ``.npz`` layout.

The whole carry (state tree, per-ray statics with the activity mask, the
step counter) round-trips through one ``.npz``: ``rays.<field>``,
``mean.<field>``, ``statics.<field>`` and the ``__msgwam_manifest__``
JSON (``step``, ``version``, ``extra``), so a checkpoint written by either
package loads in the other.  In place of the JAX package's ``key`` the port
stores a ``torch.Generator``'s state (``generator``) and its device
(``generator_device``), entries the JAX loader ignores."""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch

from ..state import MeanState, RayState, RayStatics, State, default_device

_MANIFEST_KEY = "__msgwam_manifest__"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _text(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8)


def save_checkpoint(
    path,
    state: State,
    statics: RayStatics,
    step: int = 0,
    generator: Optional[torch.Generator] = None,
    extra: Optional[dict] = None,
) -> None:
    """Serialize the simulation carry to ``path`` (.npz)."""
    arrays = {}
    for name, val in zip(RayState._fields, state.rays):
        arrays[f"rays.{name}"] = _host(val)
    for name, val in zip(MeanState._fields, state.mean):
        arrays[f"mean.{name}"] = _host(val)
    for name, val in zip(RayStatics._fields, statics):
        arrays[f"statics.{name}"] = _host(val)
    if generator is not None:
        arrays["generator"] = generator.get_state().numpy()
        arrays["generator_device"] = _text(str(generator.device))
    manifest = {"step": int(step), "version": 1, "extra": extra or {}}
    arrays[_MANIFEST_KEY] = _text(json.dumps(manifest))
    np.savez(path, **arrays)


def load_checkpoint(path, device=None) -> Tuple[
        State, RayStatics, int, Optional[torch.Generator], dict]:
    """Restore ``(state, statics, step, generator, extra)`` from ``path``,
    the tensors on ``device`` (the card unless another device is given,
    :func:`msgwam_tpu_torch.state.default_device`).  The generator is
    rebuilt on the device it was saved from.  A checkpoint written by the
    JAX package carries a JAX ``key`` instead: its state and statics load,
    and the generator is ``None`` (a JAX key has no ``torch.Generator``
    counterpart)."""
    device = default_device(device)
    with np.load(path) as z:
        manifest = json.loads(bytes(z[_MANIFEST_KEY]).decode())

        def load(prefix, cls):
            return cls(*(torch.from_numpy(np.array(z[f"{prefix}.{n}"])).to(device)
                         for n in cls._fields))

        state = State(load("rays", RayState), load("mean", MeanState))
        statics = load("statics", RayStatics)
        generator = None
        if "generator" in z.files:
            generator = torch.Generator(
                device=bytes(z["generator_device"]).decode())
            generator.set_state(torch.from_numpy(np.array(z["generator"])))
    return state, statics, manifest["step"], generator, manifest.get("extra", {})
